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

Four branches: a slot batch with no spill tail (at any window of 128 to
1024 rows) runs the whole model in one ``gat_local_model_slots`` launch,
after the layer-0 projection and skip matmuls in plain torch; any other slot batch (a spill tail,
``return_intermediates``, no ``pool_gl``) runs the per-layer slot path, as
the JAX package does: per layer one ``gat_local_message_slots`` launch
(kernel table row 21) for the softmax over the slots, with the spill tail's
numerators and denominators summed through ``base.spill_segment_sum`` (row
24) and the divide, skip projection, ELU and next projection in plain
torch; an ELL batch runs the per-layer ELL path
(``flowgnn_tpu/models/gat.py:355-393, 428-448``): per layer one
``gat_local_message_ell`` launch (row 17) for the window-local sums, the
spill tail's through ``base.ell_spill_segment_sum`` (row 24), and the same
plain-torch glue; a plain edge-list batch, and a legacy local batch
(``blocked="local"``), runs the plain loop, the port's own oracle, and an
edge-block batch (``blocked=True``) the same loop with its [scored ‖ score]
sum through the windowed scatter (``base.edge_segment_sum``, row 24). The
JAX package picks one of three GAT megakernels by environment
(``FLOWGNN_GAT_PAIRS``, ``FLOWGNN_GAT_DENSE``); they compute the same
function, and the port has one kernel for all three.

With ``fuse_layers`` (default ``FUSE_LAYERS``, read from
``FLOWGNN_GAT_FUSE`` when the module is imported, as the JAX module reads
it) every ELL layer but the last runs ``gat_local_layer_ell`` (row 23)
instead of row 17 and the glue: the sums, the spill tail's pre-reduced sums,
the divide, skip projection, ELU and the next layer's projection and scores
in one launch, in f32 with one rounding at the end, where the unfused path
rounds at every step, so the two agree to rounding only; the last layer runs
row 17. The port does not read ``FLOWGNN_GAT_RAWSCORES``, which hands the
JAX row 17 per-lane logits computed outside the kernel and rounded to the
compute dtype; the port computes the scores in the kernel, so the two differ
by that bf16 rounding only.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import (
    gat_glue_tiles, gat_layer_tiles, gat_local_layer_ell, gat_local_message_ell,
    gat_local_message_slots, gat_local_model_slots,
)
from . import base as _base
from .base import acc_dtype, edge_segment_sum, linear, mean_pool

LEAKY_SLOPE = 0.2
# The default of ``forward``'s ``fuse_layers``: the fused ELL layer (row 23).
FUSE_LAYERS = os.environ.get("FLOWGNN_GAT_FUSE", "0") == "1"


def _project(w_l: torch.Tensor, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[head_out, dim_out, head_in, dim_in] × [n, head_in, dim_in] as one
    [n, H·D] @ [H·D, H·D] product in the accumulation dtype, rounded to the
    compute dtype and quantized (``prec.q``)."""
    n = x.shape[0]
    ho, do, hi, di = w_l.shape
    acc = acc_dtype(prec)
    y = x.reshape(n, hi * di).to(acc) @ w_l.reshape(ho * do, hi * di).T.to(acc)
    return prec.q(y.to(prec.compute_dtype).reshape(n, ho, do))


def _scores(h: torch.Tensor, a: torch.Tensor, prec: Precision) -> torch.Tensor:
    """s[v, head] = Σ_dim h[v, head, dim]·a[head, dim]
    (GAT/src/load_inputs.cc:203-227), in the dtype the two promote to (the
    fixed mode's f32 h against f64 or bf16 weights, as ``jnp.einsum``
    promotes), rounded to the compute dtype and quantized."""
    dt = torch.promote_types(h.dtype, a.dtype)
    return prec.q(torch.einsum("nhd,hd->nh", h.to(dt), a.to(dt)).to(prec.compute_dtype))


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
    a_all = _score_maps(params, dt)
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
        glue_tiles=glue_tiles(params, prec),
    )


def glue_tiles(params: dict, prec: Precision) -> Optional[torch.Tensor]:
    """The bf16 slot megakernel's glue weight chunks, layers 1..L-1
    (``ops.local_layer.gat_glue_tiles`` over ``proj_w[1:]`` and
    ``skip_w[1:]`` viewed as [L−1, H·D_out, H·D_in]: packed once per weight
    set, and again after an in-place update of the weights); None outside
    bf16, where the kernel reads ``proj_w`` and ``skip_w`` as they are."""
    if prec.compute_dtype != torch.bfloat16:
        return None
    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    return gat_glue_tiles(params["proj_w"][1:].reshape(L - 1, hd, hd),
                          params["skip_w"][1:].reshape(L - 1, hd, hd))


def layer_tiles(params: dict, prec: Precision) -> Optional[torch.Tensor]:
    """The fused ELL layer's (kernel table row 23) packed weights of layers
    0..L−2, layer l's slice its skip weight and the next layer's projection
    (``ops.local_layer.gat_layer_tiles`` over ``skip_w[:L−1]`` and
    ``proj_w[1:]`` viewed as [L−1, H·D_out, H·D_in]: packed once per weight
    set, and again after an in-place update of the weights); None outside
    float32 and bf16, which the kernel does not take."""
    if prec.compute_dtype not in (torch.float32, torch.bfloat16):
        return None
    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    return gat_layer_tiles(params["skip_w"][: L - 1].reshape(L - 1, hd, hd),
                           params["proj_w"][1:].reshape(L - 1, hd, hd))


def megakernel_operands(params: dict, prec: Precision = FLOAT32) -> dict:
    """The weight operands of the GAT megakernel ablation
    (``bench.ablate_gat_mega``), each equal to the JAX package's
    ``megakernel_operands`` key of the same name: ``skip_w`` [L·HD, HD] and
    ``proj_w`` [(L−1)·HD, HD] right-multiplied (``proj_w`` from layer 1),
    ``a_next`` [(L−1)·HD, 2H] the score maps [a_src ‖ a_tgt] of layers
    1..L−1, ``pred_hd`` [HD, T] the head average composed with the
    prediction head, ``skip0_w`` layer 0's skip weight and ``glue_w``
    [(L−1)·HD, PAY+HD+H] per layer l the fused right-multiplication
    [proj_{l+1} ‖ s_tgt map ‖ 0 ‖ skip_{l+1} ‖ s_src map], PAY = max(128,
    HD+H), the score maps pre-composed with the projection in f32 and
    rounded. The JAX package's block-diagonal pair forms (``glue2_w``,
    ``ab_w``, ``pred2_w``) belong to its two-window TPU kernel and are not
    built: row 5's kernel takes ``slot_kernel_operands``."""
    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    cdt = prec.compute_dtype
    right = lambda w: w.reshape(-1, hd, hd).transpose(1, 2).reshape(-1, hd).to(cdt)
    skip_w = right(params["skip_w"])
    proj_w = right(params["proj_w"][1:])
    eye = torch.eye(H, dtype=cdt, device=params["a_src"].device)
    amat = lambda a: (a[:, :, :, None] * eye[None, :, None, :]).reshape(-1, H).to(cdt)
    a_next = torch.cat([amat(params["a_src"][1:]), amat(params["a_tgt"][1:])], dim=1)
    pay = max(128, hd + H)
    glue = []
    for l in range(L - 1):
        p_l = proj_w[l * hd : (l + 1) * hd]
        scat_w = (p_l.float() @ a_next[l * hd : (l + 1) * hd].float()).to(cdt)
        glue.append(torch.cat([
            p_l, scat_w[:, H:], torch.zeros(hd, pay - hd - H, dtype=cdt, device=p_l.device),
            skip_w[(l + 1) * hd : (l + 2) * hd], scat_w[:, :H],
        ], dim=1))
    return dict(
        skip_w=skip_w.contiguous(), proj_w=proj_w.contiguous(), a_next=a_next.contiguous(),
        pred_hd=(params["pred_w"].T / H).repeat(H, 1).to(cdt), skip0_w=skip_w[:hd].contiguous(),
        glue_w=torch.cat(glue, dim=0) if glue else torch.zeros(
            0, pay + hd + H, dtype=cdt, device=skip_w.device),
    )


def _score_maps(params: dict, dt: torch.dtype) -> torch.Tensor:
    """[L, H·D, 2H]: per layer the block-diagonal map h → [s_src ‖ s_tgt]."""
    L, H, D = params["proj_w"].shape[:3]
    eye = torch.eye(H, dtype=dt, device=params["a_src"].device)
    amap = lambda a: (a[:, :, :, None] * eye[None, :, None, :]).reshape(L, H * D, H)
    return torch.cat([amap(params["a_src"]), amap(params["a_tgt"])], dim=2)


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


def fused_layer_operands(params: dict, batch: dict, l: int, h: torch.Tensor,
                         s_src: torch.Tensor, s_tgt: torch.Tensor, prev: torch.Tensor,
                         meta: torch.Tensor, spill, a_all: torch.Tensor,
                         tiles: Optional[torch.Tensor] = None) -> dict:
    """The keyword operands the fused ELL path hands ``gat_local_layer_ell``
    for the non-final layer ``l``: h, ``prev`` [n, H, D] and the scores of
    this layer, ``meta`` and ``spill`` as in ``_ell_message``, ``a_all`` as
    ``_score_maps`` gives it, ``tiles`` as ``layer_tiles`` gives them (None:
    the wrapper packs them). ``spill_both`` is the spill tail's [Σ score·h_u
    ‖ Σ score] per node, or None without a tail."""
    n = h.shape[0]
    hd = h.shape[1] * h.shape[2]
    sp_both = None
    if spill is not None:
        sp_both = _base.ell_spill_segment_sum(spill_values(h, s_src, s_tgt, *spill), batch)
    return dict(
        ell_meta=meta, h=h.reshape(n, hd), s_src=s_src.contiguous(), s_tgt=s_tgt.contiguous(),
        prev=prev.reshape(n, hd), spill_both=sp_both,
        w_skip=params["skip_w"][l].reshape(hd, hd), w_proj=params["proj_w"][l + 1].reshape(hd, hd),
        a_mat=a_all[l + 1], window=_base.ell_geometry(batch)[0], num_heads=s_src.shape[1],
        layer_tiles=None if tiles is None else tiles[l],
    )


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32,
                          fuse_layers: bool = False) -> dict:
    """Layer 0's keyword operands of the kernels the per-layer paths run, by
    wrapper name (also used to check and time the kernels on their own):
    ``gat_local_message_slots`` on a slot batch, ``gat_local_message_ell``
    on an ELL batch (``gat_local_layer_ell`` with ``fuse_layers``), each
    with the spill scatter when the batch has a blocked spill tail; the
    windowed scatter of [scored ‖ score] on an edge-block batch."""
    prev = _raw_features(params, batch, prec)
    h = _project(params["proj_w"][0], prev, prec)
    s_src, s_tgt = _scores(h, params["a_src"][0], prec), _scores(h, params["a_tgt"][0], prec)
    if "blk_vlocal" in batch:
        u, v = batch["senders"].long(), batch["receivers"].long()
        vals = _scored(h.reshape(h.shape[0], -1)[u], _leaky_exp(s_src[v] + s_tgt[u]))
        return {"windowed_segment_sum": _base.blocked_segment_operands(vals, batch)}
    if "loc_ell" in batch:
        meta, spill = _base.ell_meta(batch), ell_spill_lanes(batch)
        if fuse_layers:
            out = {"gat_local_layer_ell": fused_layer_operands(
                params, batch, 0, h, s_src, s_tgt, prev, meta, spill,
                _score_maps(params, prec.compute_dtype), layer_tiles(params, prec))}
        else:
            out = {"gat_local_message_ell": ell_message_operands(h, s_src, s_tgt, batch, meta)}
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
    fuse_layers: bool | None = None,
):
    """[G+1, 1] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device``. ``fuse_layers`` (None: the module's
    ``FUSE_LAYERS``) runs every layer but the last of an ELL batch through
    ``gat_local_layer_ell``; any other batch ignores it. In the fixed mode
    (``prec.fixed``) every batch runs the plain loop, with ``prec.q`` at the
    JAX package's stage boundaries."""
    if fuse_layers is None:
        fuse_layers = FUSE_LAYERS
    kernels = prec.fixed is None
    slots = "slot_src" in batch and kernels
    if (
        slots and not batch["slot_spill"].shape[-1] and not return_intermediates
        and "pool_gl" in batch
    ):
        pool = gat_local_model_slots(**slot_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    prev = _raw_features(params, batch, prec)
    h = _project(params["proj_w"][0], prev, prec)  # [n, head, dim]
    lanes = _base.spill_lanes(batch) if slots and batch["slot_spill"].shape[-1] else None
    ell = "loc_ell" in batch and kernels
    fuse = ell and fuse_layers
    if ell:
        meta, spill = _base.ell_meta(batch), ell_spill_lanes(batch)
    if fuse:
        a_all = _score_maps(params, prec.compute_dtype)
        tiles = layer_tiles(params, prec)
    u, v = batch["senders"].long(), batch["receivers"].long()
    inter = [h]
    scores = None  # the fused layer's scores of the next layer
    for l in range(L):
        if scores is None:
            scores = _scores(h, params["a_src"][l], prec), _scores(h, params["a_tgt"][l], prec)
        (s_src, s_tgt), scores = scores, None
        if fuse and l != L - 1:
            n = h.shape[0]
            out = gat_local_layer_ell(**fused_layer_operands(
                params, batch, l, h, s_src, s_tgt, prev, meta, spill, a_all, tiles))
            h = out[:, :hd].contiguous().reshape(n, H, D)
            prev = out[:, hd : 2 * hd].contiguous().reshape(n, H, D)
            scores = out[:, 2 * hd : 2 * hd + H].contiguous(), out[:, 2 * hd + H :].contiguous()
            inter.append(h)
            continue
        if slots:
            msg = _slot_message(h, s_src, s_tgt, batch, lanes)
        elif ell:
            msg = _ell_message(h, s_src, s_tgt, batch, meta, spill)
        else:
            score = prec.q(_leaky_exp(s_src[v] + s_tgt[u]))  # [E, H]
            both = edge_segment_sum(_scored(h.reshape(h.shape[0], -1)[u], score), batch)
            msg = _softmax_message(both, H)
        msg = prec.q(msg)
        skip = _project(params["skip_w"][l], prev, prec)
        if l != L - 1:
            feat = msg + skip
            prev = prec.q(torch.where(feat <= 0, torch.exp(feat) - 1, feat))  # ELU
            h = _project(params["proj_w"][l + 1], prev, prec)
            inter.append(h)
        else:
            out_feat = prec.q((msg + skip).sum(dim=1) / H)  # head average
    h_graph = mean_pool(out_feat, batch, prec)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
