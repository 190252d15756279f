"""The windowed segment sum of blocked lane values.

``windowed_segment_sum`` is the counterpart of the TPU kernel
``flowgnn_tpu/ops/pallas/spmm.py:windowed_segment_sum``: it sums blocked
lane values into dense windows of output rows. The lanes come in blocks of
equal length, each block bound to one output window, and the blocks of one
window are consecutive. Two layouts feed it: the spill tail's
(``models.base._attach_spill_blocks``: windows of 512 rows, only the T
windows that receive a lane) and the edge-block layout's
(``core.blocking.build_edge_blocks``: every window of 128 rows, the blocks
left over parked on the last window as pure padding), the latter through
``segment_sum_blocked``, every model's message reduction on an
``as_batch(blocked=True)`` batch. On a CUDA tensor the wrapper launches
``csrc/windowed_segment_sum.cu``, or raises; on a CPU tensor it runs
``windowed_segment_sum_ref``, the same function in plain torch. Each launch
adds one to ``windowed_segment_sum.launches``.
"""

from __future__ import annotations

import functools

import torch

from .local_layer import (_acc_dtype, _check, _check_smem, _dispatch, _dtype_code, _knocked_out,
                          _library, _raise_on)


def windowed_segment_sum_ref(
    values: torch.Tensor,  # [P, D] lane values in blocked order
    v_local: torch.Tensor,  # [P, 1] int lane's row in its window (sentinel ``window``)
    block_window: torch.Tensor,  # [NB] int each block's window, non-decreasing
    window: int,
    num_windows: int,
) -> torch.Tensor:
    """Plain-torch ``windowed_segment_sum``: [num_windows·window, D] in the
    values' dtype, row t·window + v the sum of the lanes of window t's
    blocks whose v_local is v, in lane order. Sentinel lanes add nothing; a
    window with no block is zero. Sums run in f32 (f64 for f64 inputs) and
    round once at the end."""
    p, d = values.shape
    block = p // block_window.shape[0]
    v = v_local.reshape(-1).long()
    ok = (v >= 0) & (v < window)
    rows = block_window.long().repeat_interleave(block) * window + v
    out = torch.zeros(num_windows * window, d, dtype=_acc_dtype(values.dtype), device=values.device)
    out.index_add_(0, rows[ok], values[ok].to(out.dtype))
    return out.to(values.dtype)


# The vectors a thread of row 24 may move at once, widest first (bytes).
WSS_VECTOR_BYTES = (16, 8, 4, 2)


@functools.cache
def _wss_plan(code: int, d: int, window: int, align: int, device: int) -> tuple:
    """Row 24's launch plan at this geometry on CUDA device ``device``,
    worked out once per (dtype, D', window, alignment): (the bytes a thread
    moves at once: the widest of 16, 8, 4 and, in bf16, 2 that divides a
    row's bytes and ``align``, the pointers' common alignment; the threads a
    row: 16 where a row is at most 16 such vectors, else 32). Raises before
    launch on what the card cannot take (the block's shared memory); a
    refusal is not cached."""
    esz = 4 if code == 0 else 2
    vb = next(b for b in WSS_VECTOR_BYTES if b >= esz and (d * esz) % b == 0 and align % b == 0)
    lib = _library("windowed_segment_sum")
    _check_smem(lib, d, window, lib["smem_bytes"](), torch.device("cuda", device))
    return vb, 16 if d * esz // vb <= 16 else 32


def _alignment(*ts: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every tensor's address."""
    addr = 0
    for t in ts:
        addr |= t.data_ptr()
    return 16 if addr % 16 == 0 else addr & -addr


def _launch_wss(values, v_local, block_window, window, num_windows, knockout=0) -> torch.Tensor:
    code = _dtype_code(values.dtype)
    dev = values.device
    p, d = values.shape
    nb = block_window.shape[0]
    if nb < 1 or p % nb:
        raise ValueError(f"values: {p} lanes are not {nb} equal blocks")
    _check("values", values, values.dtype, (p, d), dev)
    _check("v_local", v_local, torch.int32, (p, 1), dev)
    _check("block_window", block_window, torch.int32, (nb,), dev)

    lib = _library("windowed_segment_sum")
    out = torch.empty((num_windows * window, d), dtype=values.dtype, device=dev)
    vb, group = _wss_plan(code, d, window, _alignment(values, out), dev.index)
    rc = lib["launch"](
        code, values.data_ptr(), v_local.data_ptr(), block_window.data_ptr(), out.data_ptr(),
        nb, p // nb, d, window, num_windows, vb, group, int(knockout),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "windowed_segment_sum")
    windowed_segment_sum.launches += 1
    return out


def windowed_segment_sum(
    values: torch.Tensor,
    v_local: torch.Tensor,
    block_window: torch.Tensor,
    window: int,
    num_windows: int,
    knockout: int = 0,
) -> torch.Tensor:
    """[num_windows·window, D] windowed sums in the values' dtype. Operands
    as in ``windowed_segment_sum_ref``; a CPU tensor runs the plain version,
    a CUDA tensor launches the kernel (float32 or bfloat16 values, int32
    ``v_local`` / ``block_window``; one block per window and 128-row slice,
    its plan from ``_wss_plan``) or raises. ``knockout`` (timing only, CUDA
    only): bit 1 skips the sums (the index pass runs, zeros are written)."""
    args = (values, v_local, block_window, window, num_windows)
    if _knocked_out(values, knockout):
        return _launch_wss(*args, knockout=knockout)
    return _dispatch(values, windowed_segment_sum_ref, _launch_wss, args)


windowed_segment_sum.launches = 0


def segment_sum_blocked(
    vals: torch.Tensor,  # [P, D] edge values already in block order
    v_local: torch.Tensor,  # [P] int lane's receiver row in its window (sentinel ``window``)
    block_window: torch.Tensor,  # [NB] int each block's window, non-decreasing
    num_nodes: int,
    window: int,
) -> torch.Tensor:
    """Per-node sum [num_nodes, D] of edge values in the edge-block order
    (``flowgnn_tpu/ops/pallas/spmm.py:segment_sum_blocked``): one
    ``windowed_segment_sum`` over all ⌈num_nodes / window⌉ windows, cut to
    the node rows. Pad lanes carry the sentinel and add nothing, so the
    values need no mask."""
    num_windows = -(-num_nodes // window)
    out = windowed_segment_sum(vals, v_local[:, None], block_window, window, num_windows)
    return out[:num_nodes]
