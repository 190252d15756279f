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

Three branches: a slot batch (``as_batch(blocked="local_slots")``) runs the
whole model in one ``gin_local_model_slots`` launch, an ELL batch
(``blocked="local_ell"``) in one ``gin_local_model`` launch, and a plain
edge-list batch runs the plain torch path, the port's own end-to-end
oracle. A slot batch the megakernel does not take (a spill tail, no
``pool_gl``, ``return_intermediates``) runs the plain path on its own edge
list, as the JAX package's dispatch falls through to its plain loop; an ELL
batch the ELL kernel does not take raises ``NotImplementedError`` naming
what it needs.

The FPGA drops ε (GIN/src/host.cc:185-200), so ``fpga_eps=True`` (default)
zeroes it for device parity; ``False`` uses the trained value.
"""

from __future__ import annotations

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import gin_local_model, gin_local_model_slots
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
    r = relu(h + ee0).to(h.dtype)
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
        eps_all=(1.0 + _eps(params, prec, fpga_eps)).to(acc_dtype(prec)).reshape(L, 1),
        pred_w=params["pred_w"].T.to(dt).contiguous(),
        num_layers=L, gmax=_base.POOL_GMAX,
        vn_col=batch["vn_mask"].to(dt) if "vn_mask" in batch else None,
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


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    fpga_eps: bool = True,
    return_intermediates: bool = False,
):
    """[G+1, T] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device``."""
    _base.reject_unported_layouts(batch, ell=True)
    if "loc_ell" in batch:
        _base.require_ell_megakernel(batch, return_intermediates, layer_row=13)
        pool = gin_local_model(**ell_kernel_operands(params, batch, prec, fpga_eps))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)
    if "slot_meta" in batch and "pool_gl" in batch and not return_intermediates:
        pool = gin_local_model_slots(**slot_kernel_operands(params, batch, prec, fpga_eps))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    L = params["mlp1_w"].shape[0]
    eps = _eps(params, prec, fpga_eps)
    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    vn = "vn_mask" in batch
    for l in range(L):
        ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
        msg = relu(gather_sources(h, batch) + ee)
        agg = edge_segment_sum(msg, batch)
        if vn:
            agg = agg + _vn_message(h, params["edge_embedding"][l], batch, prec)
        act = agg + (1 + eps[l]) * h
        z = relu(linear(act, params["mlp1_w"][l], params["mlp1_b"][l], prec))
        z = linear(z, params["mlp2_w"][l], params["mlp2_b"][l], prec)
        h = relu(z) if l != L - 1 else z
        inter.append(h)
    h_graph = mean_pool(h, batch)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
