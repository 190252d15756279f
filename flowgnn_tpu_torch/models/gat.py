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

Two branches: a slot batch runs the whole model in one
``gat_local_model_slots`` launch, after the layer-0 projection and skip
matmuls in plain torch; a plain edge-list batch runs the plain loop, the
port's own oracle. The JAX package picks one of three GAT megakernels by
environment (``FLOWGNN_GAT_PAIRS``, ``FLOWGNN_GAT_DENSE``); they compute the
same function, and the port has one kernel for all three. A slot batch the
megakernel does not take would go to ``gat_local_message_slots`` (kernel
table row 21, not ported yet) and raises ``NotImplementedError``, as do the
ELL layouts.
"""

from __future__ import annotations

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import gat_local_model_slots
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
    if "slot_src" in batch:
        if batch["slot_spill"].shape[-1] or "slot_pstack" not in batch:
            raise NotImplementedError(
                "slot batch with a spill tail: gat_local_message_slots (kernel "
                "table row 21) is not ported yet (ROADMAP queue 1 item 9)"
            )
        if return_intermediates or "pool_gl" not in batch:
            raise NotImplementedError(
                "a slot batch without the megakernel (return_intermediates, or "
                f"more than POOL_GMAX={_base.POOL_GMAX} graphs in a window) runs "
                "gat_local_message_slots (kernel table row 21), not ported yet "
                "(ROADMAP queue 1 item 9)"
            )
        pool = gat_local_model_slots(**slot_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    L, H, D = params["proj_w"].shape[:3]
    u, v = batch["senders"].long(), batch["receivers"].long()
    prev = _raw_features(params, batch, prec)
    h = _project(params["proj_w"][0], prev, prec)  # [n, head, dim]
    inter = [h]
    for l in range(L):
        s_src = _scores(h, params["a_src"][l])
        s_tgt = _scores(h, params["a_tgt"][l])
        raw = s_src[v] + s_tgt[u]  # [E, H]
        score = torch.exp(torch.where(raw < 0, raw * LEAKY_SLOPE, raw))
        scored = (score[:, :, None] * h[u]).reshape(-1, H * D)
        both = edge_segment_sum(torch.cat([scored, score], dim=1), batch)
        msg = both[:, : H * D].reshape(-1, H, D)
        denom = both[:, H * D :]
        # Pad nodes receive no edges; keep the division defined.
        msg = msg / torch.where(denom == 0, 1, denom)[:, :, None]
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
