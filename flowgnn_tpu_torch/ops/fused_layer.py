"""The fused edge-block GIN layer: windowed scatter and MLP in one kernel.

``gin_layer_fused`` is the counterpart of the TPU kernel
``flowgnn_tpu/ops/pallas/fused_layer.py:windowed_scatter_apply`` behind
``gin_layer_fused``: over an edge-block batch (``as_batch(blocked=True)``) it
sums each node's messages, already formed per lane of the blocked edge
order, and runs GIN's node update on the sums while they are still on the
chip, so the [n, D] message tensor never reaches device memory. On a CUDA
tensor the wrapper launches ``csrc/gin_layer_fused.cu``, or raises; on a CPU
tensor it runs ``gin_layer_fused_ref``, the same function in plain torch.
Each launch adds one to ``gin_layer_fused.launches``.
"""

from __future__ import annotations

import torch

from .local_layer import (
    _acc_dtype, _check, _check_ell_geometry, _dispatch, _dtype_code, _library, _padded, _raise_on,
    block_lane_windows, check_gin_mlp, gin_epilogue, lane_rows,
)


def gin_layer_fused_ref(
    vals: torch.Tensor,  # [P, D] per-lane messages relu(h_u + ee) in block order
    v_local: torch.Tensor,  # [P] int lane's receiver row in its window (sentinel ``window``)
    block_window: torch.Tensor,  # [NB] int each block's window, non-decreasing
    h: torch.Tensor,  # [n, D] layer input
    w1: torch.Tensor,  # [H, D]
    b1: torch.Tensor,  # [H]
    w2: torch.Tensor,  # [D, H]
    b2: torch.Tensor,  # [D]
    eps1: torch.Tensor,  # [1, 1] 1+ε, float32 (float64 for f64 h)
    window: int,
    final_relu: bool,
) -> torch.Tensor:
    """Plain-torch ``gin_layer_fused``: the next h [n, D] in h's dtype. Per
    window row v over its lanes in lane order acc = Σ vals in f32 (sentinel
    lanes add nothing), act = rnd(acc + (1+ε)·h), z = rnd(relu(act·w1ᵀ +
    b1)), out = rnd(z·w2ᵀ + b2) with a ReLU when ``final_relu``; ``rnd``
    rounds to h's dtype, products and sums run in f32 (f64 for f64
    inputs)."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    rows = -(-h.shape[0] // window) * window
    dest, ok = lane_rows(v_local, block_lane_windows(block_window, vals.shape[0]), window)
    agg = torch.zeros(rows, h.shape[1], dtype=acc, device=h.device)
    agg.index_add_(0, dest[ok], vals[ok].to(acc))
    out = gin_epilogue(agg, _padded(h, rows).to(acc), None, w1, b1, w2, b2, eps1, final_relu, cdt)
    return out[: h.shape[0]]


def _launch_gin_fused(vals, v_local, block_window, h, w1, b1, w2, b2, eps1, window,
                      final_relu) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    p = vals.shape[0]
    nb = block_window.shape[0]
    hid = check_gin_mlp(h, None, w1, b1, w2, b2, eps1)
    if nb < 1 or p % nb:
        raise ValueError(f"vals: {p} lanes are not {nb} equal blocks")
    _check("vals", vals, dt, (p, d), dev)
    _check("v_local", v_local, torch.int32, (p,), dev)
    _check("block_window", block_window, torch.int32, (nb,), dev)
    nw = -(-n // window)
    lib = _library("gin_layer_fused")
    _check_ell_geometry(lib, d, window, lib["smem_bytes"](d), dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, vals.data_ptr(), v_local.data_ptr(), block_window.data_ptr(), h.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), eps1.data_ptr(),
        out.data_ptr(), nw, n, window, nb, p // nb, d, hid, int(bool(final_relu)),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gin_layer_fused")
    gin_layer_fused.launches += 1
    return out


def gin_layer_fused(
    vals: torch.Tensor,
    v_local: torch.Tensor,
    block_window: torch.Tensor,
    h: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps1: torch.Tensor,
    window: int,
    final_relu: bool,
) -> torch.Tensor:
    """One whole GIN layer over an edge-block batch, messages already
    formed: the next h [n, D] in h's dtype (``csrc/gin_layer_fused.cu``).
    Operands as in ``gin_layer_fused_ref``; a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (float32 or bfloat16 ``vals``,
    h and weights, int32 ``v_local`` / ``block_window``, float32 ``eps1``)
    or raises."""
    args = (vals, v_local, block_window, h, w1, b1, w2, b2, eps1, window, final_relu)
    return _dispatch(h, gin_layer_fused_ref, _launch_gin_fused, args)


gin_layer_fused.launches = 0
