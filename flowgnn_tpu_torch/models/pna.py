"""PNA over packed batches (4 aggregators × 3 scalers, dim 80, 4 layers).

The counterpart of ``flowgnn_tpu.models.pna.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:pna_forward`` for citations): per layer
the sum, sum of squares and running min / max of the in-neighbours' h, the
min / max seeded at the ap_fixed extremes (PNA/src/message_passing.cc:
121-147); mean and std normalised by in-degree; scalers (1, t, 1/t) from
log(out_deg + 1)/avg_deg (PNA/src/node_embedding.cc:123-214); one
[4D → D] tower per scaler; residual h + relu(acc); readout MLP
dim → 40 → 20 → 1 (PNA/src/finalize.cc:34-52).

Three branches: a slot batch with no spill tail runs the whole conv stack
and readout MLP-1 in one ``pna_local_model`` launch, then MLP-2/3 in plain
torch; a slot batch with a spill tail runs the per-layer slot path, as the
JAX package does: per layer ``pna_local_stats_ell`` (kernel table row 19)
gives the slot aggregates, the spill tail adds its sums through
``base.spill_segment_sum`` (row 24) and its min / max through
``segment_min`` / ``segment_max``, and the tower, ``mean_pool`` and the
readout are plain torch; a plain edge-list batch runs the plain loop, the
port's own oracle. A slot batch with no spill tail that the megakernel does
not take (``return_intermediates``, or no ``pool_gl``) would go to
``pna_local_layer`` (row 20, not ported yet) and raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import pna_local_model, pna_local_stats_ell
from ..ops.segment import segment_max, segment_min
from . import base as _base
from .base import edge_segment_sum, gather_sources, in_degree, linear, mean_pool, out_degree, relu

# ap_fixed<16,6> extremes that seed the running min / max accumulators
# (PNA/src/util.h ap_fixed_min / ap_fixed_max).
MIN_INIT = -32.0
MAX_INIT = 32767 / 1024


def _degree_terms(params: dict, batch: dict, prec: Precision):
    """(in_deg, t, scale), each [n, 1] in the compute dtype. The reference's
    asymmetry is kept: the mean divides by in-degree (0 → 1), the scalers
    use log(out_degree + 1) (PNA/src/load_inputs.cc:87-105)."""
    dt = prec.compute_dtype
    in_deg = torch.clamp_min(in_degree(batch), 1).to(dt)[:, None]
    log_deg = torch.log(out_degree(batch).to(dt) + 1)[:, None]
    avg_deg = params["avg_deg"]
    t = log_deg / avg_deg
    pos = log_deg > 0
    scale = torch.where(pos, avg_deg / torch.where(pos, log_deg, 1), 1.0)
    return in_deg, t, scale


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the slot branch hands ``pna_local_model`` for a
    slot batch (also used to time the kernel on its own)."""
    dt = prec.compute_dtype
    L, d = params["conv_w"].shape[:2]
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    in_deg, t, scale = _degree_terms(params, batch, prec)
    # Per layer [4D, 3D] = [w_noneᵀ ‖ w_tᵀ ‖ w_scaleᵀ] (flowgnn_tpu pna.py:85-97).
    w_all = params["conv_w"].reshape(L, d, 3, 4 * d).permute(0, 3, 2, 1).reshape(L * 4 * d, 3 * d)
    return dict(
        slot_src=batch["slot_src"],
        h0=_base.atom_embed(params["node_embedding"], batch["node_feat"], prec),
        inv_deg=(1.0 / in_deg)[:, 0], t=t[:, 0], scale=scale[:, 0],
        w_all=w_all, b_all=params["conv_b"], pool_gl=batch["pool_gl"],
        mlp1_w=params["mlp1_w"].T.to(dt).contiguous(),
        window=window, slots=n_slots, num_layers=L, gmax=_base.POOL_GMAX,
        # Kernel argument order: (min-accumulator seed, max-accumulator seed).
        min_init=MAX_INIT, max_init=MIN_INIT,
        prefix_caps=_base.slot_prefix_caps(batch, n_slots),
    )


def _readout_tail(z: torch.Tensor, params: dict, prec: Precision) -> torch.Tensor:
    """ReLU, then readout MLP-2 and MLP-3."""
    z = relu(linear(relu(z), params["mlp2_w"], params["mlp2_b"], prec))
    return linear(z, params["mlp3_w"], params["mlp3_b"], prec)


def _aggregates(h: torch.Tensor, batch: dict):
    """(sum, sum², min, max) of the in-neighbours' h over the plain edge
    list."""
    n, d = h.shape
    v = batch["receivers"]
    x = gather_sources(h, batch)
    ss = edge_segment_sum(torch.cat([x, x * x], dim=1), batch)
    return ss[:, :d], ss[:, d:], segment_min(x, v, n, MAX_INIT), segment_max(x, v, n, MIN_INIT)


def stats_operands(h: torch.Tensor, batch: dict) -> dict:
    """The keyword operands the per-layer slot path hands
    ``pna_local_stats_ell`` for the layer input ``h``."""
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    # Kernel argument order: (min-accumulator seed, max-accumulator seed).
    return dict(slot_src=batch["slot_src"], h=h, window=window, slots=n_slots,
                min_init=MAX_INIT, max_init=MIN_INIT)


def spill_values(h: torch.Tensor, batch: dict, lanes) -> tuple[torch.Tensor, torch.Tensor]:
    """(the spill lanes' source h, their [h ‖ h²] sum channels)."""
    x = _base.spill_gather(h, lanes[0])
    return x, torch.cat([x, x * x], dim=1)


def _slot_aggregates(h: torch.Tensor, batch: dict, lanes):
    """(sum, sum², min, max) over a slot batch with a spill tail: the slot
    aggregates of ``pna_local_stats_ell``, rounded to h's dtype as the
    kernel gives them, then the spill tail's sums, mins and maxes merged
    in."""
    n, d = h.shape
    st = pna_local_stats_ell(**stats_operands(h, batch))
    sp_v = lanes[1]
    x, sums = spill_values(h, batch, lanes)
    ss = _base.spill_segment_sum(sums, batch)
    return (
        st[:, :d] + ss[:, :d], st[:, d : 2 * d] + ss[:, d:],
        torch.minimum(st[:, 2 * d : 3 * d], segment_min(x, sp_v, n, MAX_INIT)),
        torch.maximum(st[:, 3 * d :], segment_max(x, sp_v, n, MIN_INIT)),
    )


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """Layer 0's keyword operands of the kernels the per-layer slot path
    runs on a slot batch with a spill tail, by wrapper name (also used to
    check and time the kernels on their own)."""
    h = _base.atom_embed(params["node_embedding"], batch["node_feat"], prec)
    sums = spill_values(h, batch, _base.spill_lanes(batch))[1]
    return {
        "pna_local_stats_ell": stats_operands(h, batch),
        "windowed_segment_sum": _base.spill_segment_operands(sums, batch),
    }


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
):
    """[G+1, 1] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device``."""
    _base.reject_unported_layouts(batch)
    slots = "slot_src" in batch
    if slots and not batch["slot_spill"].shape[-1]:
        if return_intermediates or "pool_gl" not in batch:
            raise NotImplementedError(
                "a slot batch without the megakernel (return_intermediates, or "
                f"more than POOL_GMAX={_base.POOL_GMAX} graphs in a window) runs "
                "pna_local_layer (kernel table row 20), not ported yet "
                "(ROADMAP queue 2 B)"
            )
        pool = pna_local_model(**slot_kernel_operands(params, batch, prec))
        return _readout_tail(_base.pool_finish(pool, batch, params["mlp1_b"], prec), params, prec)

    L = params["conv_w"].shape[0]
    in_deg, t, scale = _degree_terms(params, batch, prec)
    h = _base.atom_embed(params["node_embedding"], batch["node_feat"], prec)
    lanes = _base.spill_lanes(batch) if slots else None
    inter = [h]
    for l in range(L):
        s, s2, mn, mx = _slot_aggregates(h, batch, lanes) if slots else _aggregates(h, batch)
        mean = s / in_deg
        std = torch.sqrt(relu(s2 / in_deg - mean * mean))
        # [n, 4·dim] in enum order (mean, min, max, std), PNA/src/dcl.h:29-35.
        stats = torch.cat([mean, mn, mx, std], dim=1)
        # The tower is linear in the stats, so the three scalers distribute:
        # acc = W_none·stats + t·(W_t·stats) + scale·(W_scale·stats).
        wl = params["conv_w"][l]  # [D_out, 3, 4, D_in]
        w_none, w_t, w_scale = (wl[:, i].reshape(wl.shape[0], -1) for i in range(3))
        acc = (
            linear(stats, w_none, params["conv_b"][l], prec)
            + t * linear(stats, w_t, None, prec)
            + scale * linear(stats, w_scale, None, prec)
        )
        h = h + relu(acc)
        inter.append(h)
    h_graph = mean_pool(h, batch)
    out = _readout_tail(linear(h_graph, params["mlp1_w"], params["mlp1_b"], prec), params, prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
