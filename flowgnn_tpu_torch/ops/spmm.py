"""The spill tail's windowed segment sum.

``windowed_segment_sum`` is the counterpart of the TPU kernel
``flowgnn_tpu/ops/pallas/spmm.py:windowed_segment_sum``: it sums blocked
lane values into dense windows of output rows. The lanes come in blocks of
equal length, each block bound to one output window, and the blocks of one
window are consecutive (``models.base._attach_spill_blocks``). On a CUDA
tensor the wrapper launches ``csrc/windowed_segment_sum.cu``, or raises; on
a CPU tensor it runs ``windowed_segment_sum_ref``, the same function in plain
torch. Each launch adds one to ``windowed_segment_sum.launches``.
"""

from __future__ import annotations

import torch

from .local_layer import _acc_dtype, _check, _check_smem, _dispatch, _dtype_code, _library, _raise_on


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


def _launch_wss(values, v_local, block_window, window, num_windows) -> torch.Tensor:
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
    _check_smem(lib, d, window, lib["smem_bytes"](window), dev)
    out = torch.empty((num_windows * window, d), dtype=values.dtype, device=dev)
    rc = lib["launch"](
        code, values.data_ptr(), v_local.data_ptr(), block_window.data_ptr(), out.data_ptr(),
        nb, p // nb, d, window, num_windows,
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
) -> torch.Tensor:
    """[num_windows·window, D] windowed sums in the values' dtype. Operands
    as in ``windowed_segment_sum_ref``; a CPU tensor runs the plain version,
    a CUDA tensor launches the kernel (float32 or bfloat16 values, int32
    ``v_local`` / ``block_window``) or raises."""
    args = (values, v_local, block_window, window, num_windows)
    return _dispatch(values, windowed_segment_sum_ref, _launch_wss, args)


windowed_segment_sum.launches = 0
