"""GCN over packed batches.

The counterpart of ``flowgnn_tpu.models.gcn.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:gcn_forward`` for citations): the
reference fuses the previous layer's tail (root-embedding residual,
BatchNorm, ReLU) in front of each conv matmul and the final tail (no ReLU)
into pooling; messages are norm-scaled relu(h_u + ee_l) with norm_uv =
1/√(deg_u+1)/√(deg_v+1) over out-degrees (GCN/src/load_inputs.cc:121-163,
GCN/src/message_passing.cc:148-167). Like the JAX package, a node that is
never a source gets 1/√(0+1) = 1, where the reference leaves 0.

Three branches: a slot batch (``as_batch(blocked="local_slots")``) runs all
L layers and the pooled head in one ``gcn_local_model_slots`` launch after
the conv-0 matmul, an ELL batch (``blocked="local_ell"``) in one
``gcn_local_model`` launch; every other batch, and a slot batch the kernel
does not take (a spill tail, ``return_intermediates``, no ``pool_gl``), runs
the plain edge-list loop, as the JAX package's dispatch falls through to
it. An ELL batch the ELL kernel does not take raises
``NotImplementedError`` naming what it needs.
"""

from __future__ import annotations

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import gcn_local_model, gcn_local_model_slots
from . import base as _base
from .base import (
    acc_dtype,
    atom_embed,
    bond_embed,
    edge_segment_sum,
    gather_sources,
    linear,
    mean_pool,
    out_degree,
    relu,
)

# Device BatchNorm uses sqrt(var + ap_fixed ulp) (GCN/src/load_inputs.cc:33).
BN_EPS = 1.0 / 1024


def _folded_bn(params: dict, prec: Precision):
    """(alphas, betas) [L, D]: BatchNorm folded to x·alpha + beta. The JAX
    package takes the root in f32; the port takes it in the accumulation
    dtype, which is f32 in the f32 and bf16 modes and f64 in the f64 mode,
    so that the f64 slot path equals the plain one to f64 rounding."""
    dt = prec.compute_dtype
    s = torch.sqrt(params["bn_var"].to(acc_dtype(prec)) + BN_EPS)
    alphas = (params["bn_weight"] / s).to(dt)
    betas = (params["bn_bias"] - params["bn_mean"] * alphas).to(dt)
    return alphas, betas


def _model_operands(params: dict, batch: dict, prec: Precision) -> dict:
    """The whole-model kernels' operands other than the layout's. The conv-0
    matmul, the degree norms and the folded BatchNorm are plain torch, as
    the JAX package computes them outside Pallas."""
    dt = prec.compute_dtype
    L, d, _ = params["conv_w"].shape
    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    alphas, betas = _folded_bn(params, prec)
    return dict(
        h0=linear(h, params["conv_w"][0], params["conv_b"][0], prec),
        dis=1.0 / torch.sqrt(out_degree(batch).to(dt) + 1),
        pool_gl=batch["pool_gl"],
        ee_tables=params["edge_embedding"].reshape(-1, d).to(dt),
        roots=params["root_emb"], alphas=alphas, betas=betas,
        wn_all=params["conv_w"][1:].transpose(1, 2).reshape((L - 1) * d, d).contiguous(),
        bn_all=params["conv_b"][1:],
        pred_w=params["pred_w"].T.to(dt).contiguous(),
        num_layers=L, gmax=_base.POOL_GMAX,
    )


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the slot branch hands ``gcn_local_model_slots``
    for a slot batch (also used to time the kernel on its own)."""
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    return dict(
        slot_meta=batch["slot_meta"], window=window, slots=n_slots,
        prefix_caps=_base.slot_prefix_caps(batch, n_slots),
        **_model_operands(params, batch, prec),
    )


def ell_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the ELL branch hands ``gcn_local_model`` for an
    ELL batch (also used to time the kernel on its own)."""
    return dict(
        ell_meta=_base.ell_meta(batch), window=_base.ell_geometry(batch)[0],
        **_model_operands(params, batch, prec),
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
    _base.reject_unported_layouts(batch, ell=True)
    if "loc_ell" in batch:
        _base.require_ell_megakernel(batch, return_intermediates, layer_row=15)
        pool = gcn_local_model(**ell_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)
    if "slot_meta" in batch and "pool_gl" in batch and not return_intermediates:
        pool = gcn_local_model_slots(**slot_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    dt = prec.compute_dtype
    L = params["conv_w"].shape[0]
    u, v = batch["senders"].long(), batch["receivers"].long()
    deg = out_degree(batch).to(dt)
    dis = 1.0 / torch.sqrt(deg + 1)
    norm = (dis[u] * dis[v])[:, None]

    def tail(m, h, l):
        a = m + relu(h + params["root_emb"][l]) / (deg[:, None] + 1)
        s = torch.sqrt(params["bn_var"][l] + BN_EPS)
        return (a - params["bn_mean"][l]) / s * params["bn_weight"][l] + params["bn_bias"][l]

    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    m = torch.zeros_like(h)
    inter = [h]
    for l in range(L):
        a = h if l == 0 else relu(tail(m, h, l - 1))
        h = linear(a, params["conv_w"][l], params["conv_b"][l], prec)
        ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
        m = edge_segment_sum(norm * relu(gather_sources(h, batch) + ee), batch)
        inter.append(h)
    a = tail(m, h, L - 1)  # the final tail has no ReLU (GCN/src/finalize.cc:88-96)
    h_graph = mean_pool(a, batch)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
