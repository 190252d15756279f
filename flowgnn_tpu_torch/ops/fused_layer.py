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

from typing import Optional

import torch

from .local_layer import (
    _acc_dtype, _check, _check_pairs, _dispatch, _dtype_code, _gin_layer_plan, _knocked_out,
    _library, _mlp_operand, _padded, _raise_on, block_lane_windows, check_gin_mlp, gin_epilogue,
    lane_rows,
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
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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
                      final_relu, tiles, knockout=0) -> torch.Tensor:
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
    _check_pairs(("vals", vals), ("h", h))
    name = "gin_layer_fused"
    lib = _library(name)
    stages, _ = _gin_layer_plan(name, code, d, hid, 0, window, dev.index)
    if code == 1:  # the wgmma MLP reads the layer's weights as packed chunks
        tiles = _mlp_operand(None, tiles, w1, w2, 1, per_layer=True)
    nw = -(-n // window)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, vals.data_ptr(), v_local.data_ptr(), block_window.data_ptr(), h.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), eps1.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(), nw, n, window, nb, p // nb, d,
        hid, int(bool(final_relu)), stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, name)
    gin_layer_fused.launches += 1
    gin_layer_fused.stages = stages
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
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole GIN layer over an edge-block batch, messages already
    formed: the next h [n, D] in h's dtype (``csrc/gin_layer_fused.cu``).
    Operands as in ``gin_layer_fused_ref``; a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (float32 or bfloat16 ``vals``,
    h and weights, int32 ``v_local`` / ``block_window``, float32 ``eps1``)
    or raises. In bfloat16 the update MLP runs on the tensor cores from
    ``mlp_tiles``, this layer's slice of ``local_layer.mlp_tiles()`` (packed
    here, once per weight set, when not given; ``gin_layer_fused.stages``
    the weight ring). ``knockout`` times the CUDA kernel without a stage
    (bit 0 the MLP, bit 1 the message sums; the models never set it)."""
    args = (vals, v_local, block_window, h, w1, b1, w2, b2, eps1, window, final_relu, mlp_tiles)
    if _knocked_out(h, knockout):
        return _launch_gin_fused(*args, knockout=knockout)
    return _dispatch(h, gin_layer_fused_ref, _launch_gin_fused, args)


gin_layer_fused.launches = 0
gin_layer_fused.stages = 0
