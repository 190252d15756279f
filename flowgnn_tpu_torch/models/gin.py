"""GIN / GIN-VN over packed batches.

The counterpart of ``flowgnn_tpu.models.gin.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:gin_forward`` for citations): message
m[v] = Σ_{u→v} relu(h_u + ee_l); update h' = MLP_l((1+ε)h + m) with MLP
dim→2·dim→dim, ReLU between and after except the last layer; readout
mean-pool → linear.

GIN-VN runs the same program over graphs with an analytic virtual node
(``core.graphs.add_virtual_node_analytic``): its star messages are a
per-graph pooled sum plus a per-graph broadcast (``_vn_message`` here, the
VN stage inside the slot megakernel).

Six branches: a slot batch (``as_batch(blocked="local_slots")``) runs the
whole model in one ``gin_local_model_slots`` launch, an ELL batch
(``blocked="local_ell"``) with one edge block per window, no spill tail and
the pooling layout in one ``gin_local_model`` launch, every other ELL batch
(k > 1, a spill tail, no ``pool_gl``, ``return_intermediates``) the
per-layer ELL path, a legacy local batch (``blocked="local"``) one
``gin_local_layer`` launch per layer (kernel table row 10), an edge-block
batch (``blocked=True``) the plain loop with its message sum through the
windowed scatter (``base.edge_segment_sum``, row 24) or, with ``fused=True``
and no virtual node, one ``gin_layer_fused`` launch per layer (row 25: the
sum and the MLP in one kernel), and a plain edge-list batch the plain torch
path, the port's own end-to-end oracle. A slot batch the megakernel does
not take (a spill tail, no ``pool_gl``, ``return_intermediates``) runs the
plain path on its own edge list, as the JAX package's dispatch falls
through to its plain loop.

The legacy local path (``flowgnn_tpu/models/gin.py:269-290``): per layer the
bond embeddings of every lane (``bond_embed`` over the blocked edge order),
the un-blocked spill tail's messages summed per node by a plain
``segment_sum``, even when nothing spills, GIN-VN's VN messages folded into
that sum, and one ``gin_local_layer`` launch for the window-local messages
and the MLP.

The per-layer ELL path (``flowgnn_tpu/models/gin.py:192-268``, without its
halo branch): per layer the spill tail's messages relu(h_u + ee) are
gathered by index (``base.spill_gather``) and summed per node by the spill
scatter (``base.ell_spill_segment_sum``, kernel table row 24), GIN-VN adds
its VN messages, and one ``gin_local_layer_ell`` launch (row 13) runs the
window-local messages and the MLP; ``mean_pool`` and the readout are plain
torch.

The FPGA drops ε (GIN/src/host.cc:185-200), so ``fpga_eps=True`` (default)
zeroes it for device parity; ``False`` uses the trained value.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.fused_layer import gin_layer_fused
from ..ops.local_layer import (
    gin_local_layer, gin_local_layer_ell, gin_local_model, gin_local_model_slots, mlp_tiles,
)
from ..ops.segment import segment_sum
from . import base as _base
from .base import (
    acc_dtype,
    atom_embed,
    bond_embed,
    edge_segment_sum,
    gather_sources,
    linear,
    mean_pool,
    relu,
)


def _vn_message(h: torch.Tensor, table_l: torch.Tensor, batch: dict,
                prec: Precision) -> torch.Tensor:
    """Analytic VN star messages: one segment pool over graph ids and one
    row broadcast back. e0 is the (0,0,0)-attr bond embedding every star
    edge shares (GIN-VN/src/host_load.cc:137-153); pad rows belong to the
    pad graph, whose row nothing reads."""
    zero_attr = torch.zeros((1, 3), dtype=torch.int32, device=h.device)
    ee0 = bond_embed(table_l, zero_attr, prec)  # [1, D]
    vn = batch["vn_mask"].to(h.dtype)[:, None]
    r = prec.q(relu(h + ee0)).to(h.dtype)
    rcat = torch.cat([r * (1 - vn), r * vn], dim=1)
    sums = segment_sum(rcat, batch["node_graph"], _base.num_graphs_static(batch))
    back = sums[batch["node_graph"].long()]
    d = h.shape[1]
    return (back[:, d:] * (1 - vn) + back[:, :d] * vn).to(h.dtype)


def _eps(params: dict, prec: Precision, fpga_eps: bool) -> torch.Tensor:
    L = params["mlp1_w"].shape[0]
    if fpga_eps:
        return torch.zeros(L, dtype=prec.compute_dtype, device=params["eps"].device)
    return params["eps"]


def eps1_all(params: dict, prec: Precision, fpga_eps: bool = True) -> torch.Tensor:
    """[L, 1] 1 + ε per layer in the accumulation dtype, as the kernels take
    it."""
    return (1.0 + _eps(params, prec, fpga_eps)).to(acc_dtype(prec)).reshape(-1, 1)


def weight_tiles(params: dict, prec: Precision) -> Optional[torch.Tensor]:
    """The bf16 GIN kernels' weight chunks of every layer, [L, C, ...]
    (``ops.local_layer.mlp_tiles``: packed once per weight set, whatever the
    buckets and layers a forward runs, and again after an in-place update of
    the weights); None outside bf16, where the kernels read W1 and W2 as
    they are."""
    if prec.compute_dtype != torch.bfloat16:
        return None
    L, hid, d = params["mlp1_w"].shape
    return mlp_tiles(params["mlp1_w"].reshape(L * hid, d), params["mlp2_w"].reshape(L * d, hid), L)


def _model_operands(params: dict, batch: dict, prec: Precision, fpga_eps: bool) -> dict:
    """The whole-model kernels' operands other than the layout's."""
    dt = prec.compute_dtype
    L, hid, d = params["mlp1_w"].shape
    return dict(
        h0=atom_embed(params["node_embedding"], batch["node_feat"], prec),
        pool_gl=batch["pool_gl"],
        ee_tables=params["edge_embedding"].reshape(-1, d).to(dt),
        w1_all=params["mlp1_w"].reshape(L * hid, d),
        b1_all=params["mlp1_b"],
        w2_all=params["mlp2_w"].reshape(L * d, hid),
        b2_all=params["mlp2_b"],
        eps_all=eps1_all(params, prec, fpga_eps),
        pred_w=params["pred_w"].T.to(dt).contiguous(),
        num_layers=L, gmax=_base.POOL_GMAX,
        vn_col=batch["vn_mask"].to(dt) if "vn_mask" in batch else None,
        mlp_tiles=weight_tiles(params, prec),
    )


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32,
                         fpga_eps: bool = True) -> dict:
    """The keyword operands the slot branch hands ``gin_local_model_slots``
    for a slot batch (also used to time the kernel on its own)."""
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    return dict(
        slot_meta=batch["slot_meta"], window=window, slots=n_slots,
        prefix_caps=_base.slot_prefix_caps(batch, n_slots),
        **_model_operands(params, batch, prec, fpga_eps),
    )


def ell_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32,
                        fpga_eps: bool = True) -> dict:
    """The keyword operands the ELL branch hands ``gin_local_model`` for an
    ELL batch (also used to time the kernel on its own)."""
    return dict(
        ell_meta=_base.ell_meta(batch), window=_base.ell_geometry(batch)[0],
        **_model_operands(params, batch, prec, fpga_eps),
    )


def ell_layer_operands(params: dict, batch: dict, prec: Precision, l: int, h: torch.Tensor,
                       meta: torch.Tensor, spill: Optional[tuple],
                       eps_all: torch.Tensor, lane_ee: bool = False) -> dict:
    """The keyword operands the per-layer ELL path hands
    ``gin_local_layer_ell`` for layer ``l`` and its input ``h``: ``meta`` is
    ``base.ell_meta(batch)``, ``spill`` is ``base.ell_spill(batch)``,
    ``eps_all`` the [L, 1] 1+ε as ``eps1_all`` gives it. ``m_spill`` is the
    spill tail's messages summed per node plus GIN-VN's VN messages, or None
    when there are neither; ``mlp_tiles`` layer ``l``'s slice of
    ``weight_tiles``. With ``lane_ee`` the bond embedding goes in per ELL
    lane (``ee``, from ``bond_embed``, rounded to the compute dtype) and not
    as the layer's table, so the layer runs the per-lane kernel (row 12)."""
    table = params["edge_embedding"][l]
    m_spill = None
    if spill is not None:
        m_spill = _base.ell_spill_segment_sum(_base.spill_messages(h, table, spill, prec), batch)
    if "vn_mask" in batch:
        vn = _vn_message(h, table, batch, prec)
        m_spill = vn if m_spill is None else (m_spill + vn).to(h.dtype)
    ops = dict(
        ell_meta=meta, h=h, m_spill=m_spill, ee_table=table.to(prec.compute_dtype),
        window=_base.ell_geometry(batch)[0], **_mlp_operands(params, prec, l, eps_all),
    )
    if lane_ee:
        lanes = batch["loc_ulocal"].shape[0]
        ops.update(ee_table=None, ee=bond_embed(table, batch["edge_attr"][:lanes], prec))
    return ops


def _mlp_operands(params: dict, prec: Precision, l: int, eps_all: torch.Tensor) -> dict:
    """Layer ``l``'s MLP operands of the per-layer GIN kernels (rows 13, 10,
    12 and 25): ``mlp_tiles`` is layer ``l``'s slice of ``weight_tiles``
    (None outside bf16)."""
    tiles = weight_tiles(params, prec)
    return dict(
        w1=params["mlp1_w"][l], b1=params["mlp1_b"][l], w2=params["mlp2_w"][l],
        b2=params["mlp2_b"][l], eps1=eps_all[l : l + 1],
        final_relu=l != params["mlp1_w"].shape[0] - 1,
        mlp_tiles=None if tiles is None else tiles[l],
    )


def _local_layer_operands(params: dict, batch: dict, prec: Precision, l: int, h: torch.Tensor,
                          ee: torch.Tensor, eps_all: torch.Tensor) -> dict:
    """The keyword operands the legacy local path hands ``gin_local_layer``
    for layer ``l`` and its input ``h``; ``ee`` is the layer's bond
    embedding of every lane, the spill tail's included. ``m_spill`` is the
    tail's messages summed per node (a plain segment sum; pad lanes sit at
    the pad node, whose row nothing reads) plus GIN-VN's VN messages."""
    p = batch["loc_ulocal"].shape[0]
    u, v = batch["senders"][p:].long(), batch["receivers"][p:]
    m_spill = segment_sum(relu(h[u] + ee[p:]), v, _base.num_nodes_static(batch))
    if "vn_mask" in batch:
        m_spill = (m_spill + _vn_message(h, params["edge_embedding"][l], batch, prec)).to(h.dtype)
    return dict(
        ee=ee[:p], u_local=batch["loc_ulocal"], v_local=batch["loc_vlocal"],
        block_window=batch["loc_window"], h=h, m_spill=m_spill, window=_base.PALLAS_WINDOW,
        **_mlp_operands(params, prec, l, eps_all),
    )


def _fused_layer_operands(params: dict, batch: dict, prec: Precision, l: int, h: torch.Tensor,
                          msg: torch.Tensor, eps_all: torch.Tensor) -> dict:
    """The keyword operands the fused edge-block path hands
    ``gin_layer_fused`` for layer ``l``: ``msg`` is relu(h_u + ee) per lane
    of the blocked edge order."""
    return dict(
        vals=msg, v_local=batch["blk_vlocal"], block_window=batch["blk_window"], h=h,
        window=_base.PALLAS_WINDOW, **_mlp_operands(params, prec, l, eps_all),
    )


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32,
                          fpga_eps: bool = True, fused: bool = False) -> dict:
    """Layer 0's keyword operands of the kernels a per-layer path runs, by
    wrapper name (also used to check and time the kernels on their own): on
    an ELL batch ``gin_local_layer_ell``, and the spill scatter
    ``windowed_segment_sum`` when the batch has a blocked spill tail; on a
    legacy local batch ``gin_local_layer``; on an edge-block batch the
    windowed scatter of the messages, or with ``fused`` (and no virtual
    node) ``gin_layer_fused``."""
    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    eps_all = eps1_all(params, prec, fpga_eps)
    if "loc_ell" not in batch:
        ee = bond_embed(params["edge_embedding"][0], batch["edge_attr"], prec)
        if "loc_ulocal" in batch:
            return {"gin_local_layer": _local_layer_operands(params, batch, prec, 0, h, ee,
                                                             eps_all)}
        msg = relu(gather_sources(h, batch) + ee)
        if fused and "vn_mask" not in batch:
            return {"gin_layer_fused": _fused_layer_operands(params, batch, prec, 0, h, msg,
                                                             eps_all)}
        return {"windowed_segment_sum": _base.blocked_segment_operands(msg, batch)}
    spill = _base.ell_spill(batch)
    out = {"gin_local_layer_ell": ell_layer_operands(
        params, batch, prec, 0, h, _base.ell_meta(batch), spill, eps_all)}
    if spill is not None and "spill_blk_vlocal" in batch:
        msg = _base.spill_messages(h, params["edge_embedding"][0], spill, prec)
        out["windowed_segment_sum"] = _base.spill_segment_operands(msg, batch)
    return out


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    fpga_eps: bool = True,
    return_intermediates: bool = False,
    fused: bool = False,
):
    """[G+1, T] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device``. ``fused`` runs each layer's message sum and
    MLP in one kernel on an edge-block batch without a virtual node (the JAX
    package's predicate; any other batch ignores it). In the fixed mode
    (``prec.fixed``) every batch runs the plain loop, with ``prec.q`` at the
    JAX package's stage boundaries."""
    kernels = prec.fixed is None
    ell = "loc_ell" in batch and kernels
    local = "loc_ulocal" in batch and "loc_ell" not in batch and kernels
    fused = fused and "blk_vlocal" in batch and "vn_mask" not in batch and kernels
    if ell and _base.ell_megakernel(batch, return_intermediates):
        pool = gin_local_model(**ell_kernel_operands(params, batch, prec, fpga_eps))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)
    if ("slot_meta" in batch and "pool_gl" in batch and not return_intermediates
            and kernels):
        pool = gin_local_model_slots(**slot_kernel_operands(params, batch, prec, fpga_eps))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    L = params["mlp1_w"].shape[0]
    eps = _eps(params, prec, fpga_eps)
    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    vn = "vn_mask" in batch
    if ell or local or fused:
        eps_all = eps1_all(params, prec, fpga_eps)
    if ell:
        meta, spill = _base.ell_meta(batch), _base.ell_spill(batch)
    for l in range(L):
        if ell:
            h = gin_local_layer_ell(**ell_layer_operands(params, batch, prec, l, h, meta,
                                                         spill, eps_all))
            inter.append(h)
            continue
        ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
        if local:
            h = gin_local_layer(**_local_layer_operands(params, batch, prec, l, h, ee, eps_all))
            inter.append(h)
            continue
        msg = relu(gather_sources(h, batch) + ee)
        if fused:
            h = gin_layer_fused(**_fused_layer_operands(params, batch, prec, l, h, msg, eps_all))
            inter.append(h)
            continue
        agg = edge_segment_sum(msg, batch)
        if vn:
            agg = agg + _vn_message(h, params["edge_embedding"][l], batch, prec)
        # eps[l : l + 1], not the 0-d eps[l]: a 0-d tensor does not promote
        # f32 to f64 in torch, where JAX's (1 + eps[l]) does (the fixed mode's
        # f32 activations against f64 weights).
        act = prec.q(prec.q(agg) + (1 + eps[l : l + 1]) * h)
        z = relu(linear(act, params["mlp1_w"][l], params["mlp1_b"][l], prec))
        z = linear(z, params["mlp2_w"][l], params["mlp2_b"][l], prec)
        h = relu(z) if l != L - 1 else z
        inter.append(h)
    h_graph = mean_pool(h, batch, prec)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
