"""The message stage alone: the counterpart of
``flowgnn_tpu/bench/spmm_stage.py``.

``measure_spmm_stage`` times the ELL message kernel with the pass-through
epilogue (row 12's: gather, message and sum, no MLP,
``ops.local_layer.gin_local_message_ell_lanes``) over the batches the model
bench ran, L = 5 layers a bucket at D = 100 with each lane's bond embedding
zero, as the JAX module does; ``measure_slot_stage`` times the slot layout's
four-aggregate kernel (row 19, ``pna_local_stats_ell``) L = 4 times a bucket
at D = 100, each layer's h the first D columns of the last stats (a copy of
them: the kernel takes h contiguous, and the copy is timed with it). Both
run over up to four buckets spread over the stream (``_spread``), timed as
``protocol.time_passes`` times a stream, and report the stage's time and,
over its useful work (one multiply-add an edge and column for the gather and
for the sum, and the stage's unavoidable bytes: the JAX module's count), the
share of the H100's light speed it reaches and the TFLOP/s it achieves.

The JAX module's ``mxu_util``, the one-hot products' FLOPs over the TPU's
matrix unit, has no counterpart: the Hopper kernels gather by index and
multiply nothing by a one-hot.
"""

from __future__ import annotations

import torch

from .protocol import time_passes
from .roofline import H100, Cost


def _spread(n: int, k: int = 4) -> list[int]:
    """Indices of up to ``k`` buckets spread across the stream (first,
    interior, last), as the JAX module samples them."""
    if n <= k:
        return list(range(n))
    return sorted({round(i * (n - 1) / (k - 1)) for i in range(k)})


def measure_spmm_stage(batches: list, prec, reps: int = 20, trials: int = 3, bf16: bool = True,
                       layers: int = 5, dim: int = 100) -> dict:
    """The ELL stage over ``batches`` (ELL batches on one device)."""
    from ..models.base import ell_geometry, ell_meta
    from ..ops.local_layer import gin_local_message_ell_lanes

    dt = prec.compute_dtype
    sampled = _spread(len(batches))
    datas = []
    lanes = real_edges = rows = 0
    for b in (batches[i] for i in sampled):
        dev = b["node_feat"].device
        meta = ell_meta(b)
        w, _ = ell_geometry(b)
        nw = -(-b["node_feat"].shape[0] // w)
        zeros = lambda r: torch.zeros(r, dim, dtype=dt, device=dev)
        datas.append((meta, w, zeros(nw * w), zeros(meta.shape[0]), zeros(nw * w)))
        lanes += meta.shape[0]
        real_edges += int((b["loc_vlocal"] < w).sum())
        rows += nw * w

    def one_pass():
        for meta, w, h0, ee, spill in datas:
            h = h0
            for _ in range(layers):
                h = gin_local_message_ell_lanes(ee, meta, h, spill, w)

    best, _ = time_passes(one_pass, reps, trials, batches[0]["node_feat"].device)
    out = _finish(real_edges, lanes, rows, best, bf16, layers, dim)
    out["sampled_buckets"] = sampled
    return out


def measure_slot_stage(batches: list, prec, reps: int = 20, trials: int = 3, bf16: bool = True,
                       layers: int = 4, dim: int = 100) -> dict:
    """The slot stage over ``batches`` (slot batches on one device); the
    slot axis auto-sizes per bucket, so two buckets of a stream may carry
    different S."""
    from ..ops.local_layer import pna_local_stats_ell

    dt = prec.compute_dtype
    sampled = _spread(len(batches))
    datas = []
    lanes = real_edges = rows = 0
    for b in (batches[i] for i in sampled):
        n = b["node_feat"].shape[0]
        w, s = (int(x) for x in b["slot_geom"].shape[-2:])
        us = b["slot_src"]
        datas.append((us, w, s, torch.zeros(n, dim, dtype=dt, device=us.device)))
        lanes += us.numel()
        real_edges += int((us < w).sum())
        rows += -(-n // w) * w

    def one_pass():
        for us, w, s, h0 in datas:
            h = h0
            for _ in range(layers):
                h = pna_local_stats_ell(us, h, w, s, 0.0, 0.0)[:, :dim].contiguous()

    best, _ = time_passes(one_pass, reps, trials, batches[0]["node_feat"].device)
    out = _finish(real_edges, lanes, rows, best, bf16, layers, dim)
    out["sampled_buckets"] = sampled
    return out


def _finish(real_edges, lanes, rows, best, bf16, layers, dim) -> dict:
    """The stage's record: µs a pass of the sampled buckets, and over its
    useful work (the JAX module's count) the share of the H100's light
    speed reached and the TFLOP/s achieved."""
    b_el = 2 if bf16 else 4
    useful = Cost(layers * 4.0 * real_edges * dim,
                  layers * b_el * (3 * rows * dim + lanes * (dim + 8)))
    return {
        "time_us": best * 1e6,
        "roofline_frac": useful.light_speed_s(H100, bf16) / best,
        "achieved_tflops": useful.flops / best / 1e12,
    }
