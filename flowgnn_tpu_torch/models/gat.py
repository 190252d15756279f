"""GAT over packed batches (4 heads × dim 16, self edges, no edge features).

The counterpart of ``flowgnn_tpu.models.gat.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:gat_forward`` for citations): layer 0
projects the raw integer node features held in head 0's slots
(GAT/src/load_inputs.cc:168-227); per layer, per head, the edge softmax of
leaky(s_src[v] + s_tgt[u], 0.2) with a raw ``exp`` and no max subtraction
(GAT/src/message_passing.cc:122-148), kept so the numerics line up with the
reference; skip projection and ELU between layers
(GAT/src/node_embedding.cc:156-196); head average and prediction head
(GAT/src/finalize.cc:90-110). Self edges must already be in the batch
(``core.graphs.add_self_loops``).

Four branches: a slot batch with no spill tail runs the whole model in one
``gat_local_model_slots`` launch, after the layer-0 projection and skip
matmuls in plain torch; any other slot batch (a spill tail,
``return_intermediates``, no ``pool_gl``) runs the per-layer slot path, as
the JAX package does: per layer one ``gat_local_message_slots`` launch
(kernel table row 21) for the softmax over the slots, with the spill tail's
numerators and denominators summed through ``base.spill_segment_sum`` (row
24) and the divide, skip projection, ELU and next projection in plain
torch; an ELL batch runs the per-layer ELL path
(``flowgnn_tpu/models/gat.py:355-393, 428-448``): per layer one
``gat_local_message_ell`` launch (row 17) for the window-local sums, the
spill tail's through ``base.ell_spill_segment_sum`` (row 24), and the same
plain-torch glue; a plain edge-list batch runs the plain loop, the port's
own oracle. The JAX package picks one of three GAT megakernels by
environment (``FLOWGNN_GAT_PAIRS``, ``FLOWGNN_GAT_DENSE``); they compute the
same function, and the port has one kernel for all three.

The port reads neither ``FLOWGNN_GAT_FUSE`` nor ``FLOWGNN_GAT_RAWSCORES``.
Under ``FLOWGNN_GAT_FUSE=1`` the JAX package runs every ELL layer but the
last through ``gat_local_layer_ell`` (kernel table row 23, not ported yet),
which moves the divide, skip, ELU, next projection and scores into its
epilogue: the same function as the port's row 17 and glue, up to rounding.
``FLOWGNN_GAT_RAWSCORES=1`` hands row 17 per-lane logits computed outside
the kernel and rounded to the compute dtype; the port computes the scores
in the kernel, so the two differ by that bf16 rounding only.
"""

from __future__ import annotations

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import (
    gat_local_message_ell, gat_local_message_slots, gat_local_model_slots,
)
from . import base as _base
from .base import acc_dtype, edge_segment_sum, linear, mean_pool

LEAKY_SLOPE = 0.2


def _project(w_l: torch.Tensor, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[head_out, dim_out, head_in, dim_in] × [n, head_in, dim_in] as one
    [n, H·D] @ [H·D, H·D] product in the accumulation dtype, rounded."""
    n = x.shape[0]
    ho, do, hi, di = w_l.shape
    acc = acc_dtype(prec)
    y = x.reshape(n, hi * di).to(acc) @ w_l.reshape(ho * do, hi * di).T.to(acc)
    return y.to(prec.compute_dtype).reshape(n, ho, do)


def _scores(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s[v, head] = Σ_dim h[v, head, dim]·a[head, dim]
    (GAT/src/load_inputs.cc:203-227)."""
    return torch.einsum("nhd,hd->nh", h, a)


def _raw_features(params: dict, batch: dict, prec: Precision) -> torch.Tensor:
    """[n, H, D] layer-0 input: the 9 raw integer features in head 0's
    first slots, zeros elsewhere."""
    _, H, D = params["proj_w"].shape[:3]
    n = _base.num_nodes_static(batch)
    prev = torch.zeros(n, H, D, dtype=prec.compute_dtype, device=batch["node_feat"].device)
    prev[:, 0, :9] = batch["node_feat"].to(prec.compute_dtype)
    return prev


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the slot branch hands ``gat_local_model_slots``
    for a slot batch (also used to time the kernel on its own). Layer 0's
    projection and skip term are plain torch matmuls, as the JAX package
    leaves them to XLA; the weights take their natural right-multiplied
    forms."""
    dt = prec.compute_dtype
    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    n = _base.num_nodes_static(batch)
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    prev = _raw_features(params, batch, prec)
    right = lambda w: w.reshape(-1, hd, hd).transpose(1, 2).reshape(-1, hd).contiguous()
    skip0 = prev.reshape(n, hd).to(acc_dtype(prec)) @ right(params["skip_w"][0]).to(acc_dtype(prec))
    # Per layer the block-diagonal [HD, 2H] maps h → [s_src ‖ s_tgt].
    eye = torch.eye(H, dtype=dt, device=prev.device)
    amap = lambda a: (a[:, :, :, None] * eye[None, :, None, :]).reshape(L, hd, H)
    a_all = torch.cat([amap(params["a_src"]), amap(params["a_tgt"])], dim=2)
    return dict(
        slot_pstack=batch["slot_pstack"],
        h0=_project(params["proj_w"][0], prev, prec).reshape(n, hd),
        skip0=skip0.to(dt),
        proj_w=right(params["proj_w"][1:]),
        skip_w=right(params["skip_w"][1:]),
        a_all=a_all.reshape(L * hd, 2 * H),
        pool_gl=batch["pool_gl"],
        # Head average ∘ prediction head: pred_hd[h·D + k] = pred_w[:, k] / H.
        pred_hd=(params["pred_w"].T / H).repeat(H, 1).to(dt),
        window=window, slots=n_slots, num_heads=H, num_layers=L,
        gmax=_base.POOL_GMAX, prefix_caps=_base.slot_prefix_caps(batch, n_slots),
    )


def _leaky_exp(raw: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.where(raw < 0, raw * LEAKY_SLOPE, raw))


def _scored(h_u: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Per edge [score·h_u ‖ score]: h_u [E, H·D], score [E, H]."""
    e, nh = score.shape
    return torch.cat([(score[:, :, None] * h_u.reshape(e, nh, -1)).reshape(e, -1), score], dim=1)


def _softmax_message(both: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-node [Σ score·h_u ‖ Σ score] [n, H·D + H] → the messages [n, H,
    D]; pad nodes receive no edges, so a zero denominator is taken as 1."""
    n, hd = both.shape[0], both.shape[1] - num_heads
    den = both[:, hd:]
    return both[:, :hd].reshape(n, num_heads, -1) / torch.where(den == 0, 1, den)[:, :, None]


def message_operands(h: torch.Tensor, s_src: torch.Tensor, s_tgt: torch.Tensor,
                     batch: dict) -> dict:
    """The keyword operands the per-layer slot path hands
    ``gat_local_message_slots`` for one layer's h [n, H, D] and scores; the
    kernel divides only when there is no spill tail to merge."""
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    return dict(
        slot_stack=batch["slot_stack"], h=h.reshape(h.shape[0], -1), s_src=s_src.contiguous(),
        s_tgt=s_tgt.contiguous(), window=window, slots=n_slots, num_heads=s_src.shape[1],
        divide=not batch["slot_spill"].shape[-1],
    )


def spill_values(h: torch.Tensor, s_src: torch.Tensor, s_tgt: torch.Tensor, lanes,
                 real: torch.Tensor) -> torch.Tensor:
    """The spill lanes' [score·h_u ‖ score], score = exp(leaky(s_src[v] +
    s_tgt[u])), ``lanes`` the tail's (senders, receivers) and ``real`` its
    lanes that carry an edge. A pad lane's score is masked before the exp,
    so it adds 0 whatever its raw score (the JAX package multiplies
    exp(raw) by the mask, which turns an overflowing pad lane into NaN)."""
    sp_u, sp_v = lanes
    real = real[:, None]
    score = torch.where(real, _leaky_exp(torch.where(real, s_src[sp_v] + s_tgt[sp_u], 0)), 0)
    return _scored(_base.spill_gather(h.reshape(h.shape[0], -1), sp_u), score)


def ell_spill_lanes(batch: dict):
    """(the tail's (senders, receivers), its lanes that carry an edge) of an
    ELL batch's spill tail, or None without one."""
    spill = _base.ell_spill(batch)
    if spill is None:
        return None
    return spill[:2], spill[1] < _base.num_nodes_static(batch) - 1


def _slot_message(h: torch.Tensor, s_src: torch.Tensor, s_tgt: torch.Tensor, batch: dict,
                  lanes) -> torch.Tensor:
    """One layer's messages [n, H, D] over a slot batch: the slot softmax of
    ``gat_local_message_slots``, divided in the kernel, or with a spill tail
    its sums merged with the tail's (``base.spill_segment_sum``) and then
    divided."""
    ops = message_operands(h, s_src, s_tgt, batch)
    out = gat_local_message_slots(**ops)
    if ops["divide"]:
        return out.reshape(h.shape)
    vals = spill_values(h, s_src, s_tgt, lanes, batch["slot_spill_mask"])
    return _softmax_message(out + _base.spill_segment_sum(vals, batch), s_src.shape[1])


def ell_message_operands(h: torch.Tensor, s_src: torch.Tensor, s_tgt: torch.Tensor,
                         batch: dict, meta: torch.Tensor) -> dict:
    """The keyword operands the per-layer ELL path hands
    ``gat_local_message_ell`` for one layer's h [n, H, D] and scores;
    ``meta`` is ``base.ell_meta(batch)``."""
    return dict(ell_meta=meta, h=h.reshape(h.shape[0], -1), s_src=s_src.contiguous(),
                s_tgt=s_tgt.contiguous(), window=_base.ell_geometry(batch)[0],
                num_heads=s_src.shape[1])


def _ell_message(h: torch.Tensor, s_src: torch.Tensor, s_tgt: torch.Tensor, batch: dict,
                 meta: torch.Tensor, spill) -> torch.Tensor:
    """One layer's messages [n, H, D] over an ELL batch: the window-local
    sums of ``gat_local_message_ell``, with a spill tail (``spill`` as
    ``ell_spill_lanes`` gives it) merged with the tail's
    (``base.ell_spill_segment_sum``), then divided."""
    both = gat_local_message_ell(**ell_message_operands(h, s_src, s_tgt, batch, meta))
    if spill is not None:
        both = both + _base.ell_spill_segment_sum(spill_values(h, s_src, s_tgt, *spill), batch)
    return _softmax_message(both, s_src.shape[1])


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """Layer 0's keyword operands of the kernels the per-layer paths run, by
    wrapper name (also used to check and time the kernels on their own):
    ``gat_local_message_slots`` on a slot batch, ``gat_local_message_ell``
    on an ELL batch, each with the spill scatter when the batch has a
    blocked spill tail."""
    h = _project(params["proj_w"][0], _raw_features(params, batch, prec), prec)
    s_src, s_tgt = _scores(h, params["a_src"][0]), _scores(h, params["a_tgt"][0])
    if "loc_ell" in batch:
        out = {"gat_local_message_ell": ell_message_operands(h, s_src, s_tgt, batch,
                                                             _base.ell_meta(batch))}
        spill = ell_spill_lanes(batch)
    else:
        out = {"gat_local_message_slots": message_operands(h, s_src, s_tgt, batch)}
        spill = None
        if batch["slot_spill"].shape[-1]:
            spill = _base.spill_lanes(batch), batch["slot_spill_mask"]
    if spill is not None and "spill_blk_vlocal" in batch:
        out["windowed_segment_sum"] = _base.spill_segment_operands(
            spill_values(h, s_src, s_tgt, *spill), batch)
    return out


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
    if (
        slots and not batch["slot_spill"].shape[-1] and not return_intermediates
        and "pool_gl" in batch
    ):
        pool = gat_local_model_slots(**slot_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    L, H = params["proj_w"].shape[:2]
    prev = _raw_features(params, batch, prec)
    h = _project(params["proj_w"][0], prev, prec)  # [n, head, dim]
    lanes = _base.spill_lanes(batch) if slots and batch["slot_spill"].shape[-1] else None
    ell = "loc_ell" in batch
    if ell:
        meta, spill = _base.ell_meta(batch), ell_spill_lanes(batch)
    u, v = batch["senders"].long(), batch["receivers"].long()
    inter = [h]
    for l in range(L):
        s_src = _scores(h, params["a_src"][l])
        s_tgt = _scores(h, params["a_tgt"][l])
        if slots:
            msg = _slot_message(h, s_src, s_tgt, batch, lanes)
        elif ell:
            msg = _ell_message(h, s_src, s_tgt, batch, meta, spill)
        else:
            score = _leaky_exp(s_src[v] + s_tgt[u])  # [E, H]
            both = edge_segment_sum(_scored(h.reshape(h.shape[0], -1)[u], score), batch)
            msg = _softmax_message(both, H)
        skip = _project(params["skip_w"][l], prev, prec)
        if l != L - 1:
            feat = msg + skip
            prev = torch.where(feat <= 0, torch.exp(feat) - 1, feat)  # ELU
            h = _project(params["proj_w"][l + 1], prev, prec)
            inter.append(h)
        else:
            out_feat = (msg + skip).sum(dim=1) / H  # head average
    h_graph = mean_pool(out_feat, batch)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
