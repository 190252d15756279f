"""GCN over packed batches.

The counterpart of ``flowgnn_tpu.models.gcn.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:gcn_forward`` for citations): the
reference fuses the previous layer's tail (root-embedding residual,
BatchNorm, ReLU) in front of each conv matmul and the final tail (no ReLU)
into pooling; messages are norm-scaled relu(h_u + ee_l) with norm_uv =
1/√(deg_u+1)/√(deg_v+1) over out-degrees (GCN/src/load_inputs.cc:121-163,
GCN/src/message_passing.cc:148-167). Like the JAX package, a node that is
never a source gets 1/√(0+1) = 1, where the reference leaves 0.

Four branches: a slot batch (``as_batch(blocked="local_slots")``, at any
window of 128 to 1024 rows) runs all L layers and the pooled head in one
``gcn_local_model_slots`` launch after the conv-0 matmul, an ELL batch (``blocked="local_ell"``) with one edge
block per window, no spill tail and the pooling layout in one
``gcn_local_model`` launch, every other ELL batch the per-layer ELL path
(``flowgnn_tpu/models/gcn.py:118-233``); every other batch, and a slot batch
the kernel does not take (a spill tail, ``return_intermediates``, no
``pool_gl``), runs the plain edge-list loop, as the JAX package's dispatch
falls through to it.

The per-layer ELL path has two forms. With no spill tail, after the conv-0
``linear`` each layer is one ``gcn_local_layer_ell`` launch (kernel table
row 15, the one-layer form of row 9's kernel: messages, root-embedding tail,
folded BatchNorm, ReLU and the next conv, in bf16 from its slice of
``conv_tiles``). With one, each layer runs its conv ``linear``, the window-local
messages through ``gcn_local_message_ell`` (row 14) and the spill tail's
norm-scaled messages, gathered by index and summed by the spill scatter
(row 24); the tail is plain torch.

Sharded (``edge_axis``, ``parallel.inference``), with the JAX package's
gates (``flowgnn_tpu/models/gcn.py:44-236``): on a halo shard the source
norms dis_u are exchanged once for all layers; an ELL shard runs the ELL
branches above per shard (row 9 when nothing spills, its pool partials
completed by ``base.pool_gather``; row 15 per layer otherwise), and one with
a spill tail runs row 14 for the window-local messages while the layer's
boundary rows are exchanged, then the spill messages from the extended rows,
summed into the trash row. The slot megakernel (row 2) does not run under an
axis. Every other sharded batch runs the plain loop, its gathers through the
halo exchange or its sums completed over the axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import (
    gcn_conv_tiles, gcn_local_layer_ell, gcn_local_message_ell, gcn_local_model,
    gcn_local_model_slots,
)
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
        conv_tiles=conv_tiles(params, prec), **_model_operands(params, batch, prec),
    )


def conv_tiles(params: dict, prec: Precision) -> Optional[torch.Tensor]:
    """The bf16 next-conv weight chunks of rows 9 and 2 and, a layer's slice
    each, of row 15: layers 1..L-1
    (``ops.local_layer.gcn_conv_tiles``: packed once per weight set, and
    again after an in-place update of the weights); None outside bf16, where
    the kernels read the weights as they are."""
    if prec.compute_dtype != torch.bfloat16:
        return None
    return gcn_conv_tiles(params["conv_w"][1:])


def ell_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the ELL branch hands ``gcn_local_model`` for an
    ELL batch (also used to time the kernel on its own)."""
    return dict(
        ell_meta=_base.ell_meta(batch), window=_base.ell_geometry(batch)[0],
        conv_tiles=conv_tiles(params, prec), **_model_operands(params, batch, prec),
    )


def _tail(params: dict, m: torch.Tensor, h: torch.Tensor, deg: torch.Tensor, l: int,
          prec: Precision) -> torch.Tensor:
    """Layer ``l``'s root-embedding residual and BatchNorm over its message
    sum ``m`` and conv output ``h`` (GCN/src/node_embedding.cc:122-146),
    quantized before and after the BatchNorm (``prec.q``)."""
    a = prec.q(m + relu(h + params["root_emb"][l]) / (deg[:, None] + 1))
    s = torch.sqrt(params["bn_var"][l] + BN_EPS)
    return prec.q((a - params["bn_mean"][l]) / s * params["bn_weight"][l]
                  + params["bn_bias"][l])


def _norms(dis: torch.Tensor, batch: dict, axis, u: torch.Tensor, v: torch.Tensor):
    """dis_u·dis_v [E', 1] for the lanes (u, v): on a halo shard dis_u from
    one exchange of the rows (``base.sender_rows``) and a pad lane's dis_v
    from the trash row (``base.receiver_rows``)."""
    dis_u = _base.sender_rows(dis[:, None], batch, axis)[:, 0]
    return (dis_u[u] * _base.receiver_rows(dis, batch, axis)[v])[:, None]


def _ell_terms(params: dict, batch: dict, prec: Precision, axis=None) -> dict:
    """What the per-layer ELL path computes once per forward: the lanes
    (``base.ell_meta``), the spill tail (``base.ell_spill``), out-degrees,
    degree norms and the spill lanes' norms dis_u·dis_v in the compute
    dtype, the folded BatchNorm, the next convs' weights as [L-1, in, out]
    and, with no spill tail, their bf16 chunks (``conv_tiles``). On a halo
    shard (``axis``) the senders' norms come from the extended rows and a
    pad lane's receiver is the trash row."""
    deg = out_degree(batch).to(prec.compute_dtype)
    dis = 1.0 / torch.sqrt(deg + 1)
    spill = _base.ell_spill(batch)
    norm = None
    if spill is not None:
        norm = _norms(dis, batch, axis, spill[0], spill[1])
    return dict(
        meta=_base.ell_meta(batch), spill=spill, deg=deg, dis=dis, norm=norm,
        folded=_folded_bn(params, prec), wn=params["conv_w"][1:].transpose(1, 2).contiguous(),
        tiles=conv_tiles(params, prec) if spill is None else None,
    )


def _layer_operands(params: dict, batch: dict, prec: Precision, l: int, h: torch.Tensor,
                    terms: dict) -> dict:
    """The keyword operands the per-layer ELL path hands
    ``gcn_local_layer_ell`` (no spill tail; in bf16 with layer ``l``'s slice
    of the next convs' chunks) or ``gcn_local_message_ell`` (a spill tail)
    for layer ``l`` and its conv output ``h``."""
    ops = dict(ell_meta=terms["meta"], h=h, dis=terms["dis"],
               ee_table=params["edge_embedding"][l].to(prec.compute_dtype),
               window=_base.ell_geometry(batch)[0])
    if terms["spill"] is not None:
        return ops
    alphas, betas = terms["folded"]
    last = l == params["conv_w"].shape[0] - 1
    tiles = terms["tiles"]
    return dict(ops, root=params["root_emb"][l], alpha=alphas[l], beta=betas[l],
                w_next=None if last else terms["wn"][l],
                b_next=None if last else params["conv_b"][l + 1],
                conv_tiles=None if last or tiles is None else tiles[l])


def _spill_messages(params: dict, prec: Precision, l: int, h: torch.Tensor,
                    terms: dict) -> torch.Tensor:
    """norm_uv · relu(h_u + ee) per spill lane of layer ``l``."""
    return terms["norm"] * _base.spill_messages(h, params["edge_embedding"][l], terms["spill"], prec)


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """Layer 0's keyword operands of the kernels the per-layer ELL path runs
    on an ELL batch, by wrapper name: ``gcn_local_layer_ell`` with no spill
    tail, ``gcn_local_message_ell`` and the spill scatter
    ``windowed_segment_sum`` with a blocked one (also used to check and time
    the kernels on their own). On an edge-block batch
    (``as_batch(blocked=True)``): the windowed scatter of the plain loop's
    normalised messages."""
    h = linear(atom_embed(params["node_embedding"], batch["node_feat"], prec),
               params["conv_w"][0], params["conv_b"][0], prec)
    if "blk_vlocal" in batch:
        dis = 1.0 / torch.sqrt(out_degree(batch).to(prec.compute_dtype) + 1)
        norm = (dis[batch["senders"].long()] * dis[batch["receivers"].long()])[:, None]
        ee = bond_embed(params["edge_embedding"][0], batch["edge_attr"], prec)
        return {"windowed_segment_sum": _base.blocked_segment_operands(
            norm * relu(gather_sources(h, batch) + ee), batch)}
    terms = _ell_terms(params, batch, prec)
    ops = _layer_operands(params, batch, prec, 0, h, terms)
    if terms["spill"] is None:
        return {"gcn_local_layer_ell": ops}
    out = {"gcn_local_message_ell": ops}
    if "spill_blk_vlocal" in batch:
        out["windowed_segment_sum"] = _base.spill_segment_operands(
            _spill_messages(params, prec, 0, h, terms), batch)
    return out


def _ell_layers(params: dict, batch: dict, prec: Precision, h: torch.Tensor, inter: list,
                axis=None):
    """The per-layer ELL path from the embedded input ``h`` to the pre-pool
    tail; appends each conv's output to ``inter``. On a halo shard
    (``axis``) with a spill tail, each layer's boundary rows are exchanged
    while row 14 sums the window-local messages, and the spill messages are
    gathered from the extended rows and summed into the trash row."""
    L = params["conv_w"].shape[0]
    terms = _ell_terms(params, batch, prec, axis)
    h = linear(h, params["conv_w"][0], params["conv_b"][0], prec)
    inter.append(h)
    if terms["spill"] is None:
        for l in range(L):
            h = gcn_local_layer_ell(**_layer_operands(params, batch, prec, l, h, terms))
            if l != L - 1:
                inter.append(h)
        return h
    for l in range(L):
        if l:
            a = relu(_tail(params, m, h, terms["deg"], l - 1, prec))
            h = linear(a, params["conv_w"][l], params["conv_b"][l], prec)
            inter.append(h)
        src = _base.sender_rows(h, batch, axis, wait=False)
        m = gcn_local_message_ell(**_layer_operands(params, batch, prec, l, h, terms))
        m = m + _base.ell_spill_segment_sum(_spill_messages(params, prec, l, src(), terms), batch)
    return _tail(params, m, h, terms["deg"], L - 1, prec)


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis=None,
):
    """[G+1, 1] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device``. In the fixed mode (``prec.fixed``) every
    batch runs the plain loop, with ``prec.q`` at the JAX package's stage
    boundaries. ``edge_axis``: the mesh axis over which the batch is
    sharded (``parallel.inference``); None on one device."""
    kernels = prec.fixed is None
    halo = _base.halo_mode(batch, edge_axis)
    single = edge_axis is None
    ell = "loc_ell" in batch and kernels and (single or halo)
    if ell and _base.ell_megakernel(batch, return_intermediates):
        pool = gcn_local_model(**ell_kernel_operands(params, batch, prec))
        pool = _base.pool_gather(pool, edge_axis)
        return _base.pool_finish(pool, batch, params["pred_b"], prec)
    if ("slot_meta" in batch and "pool_gl" in batch and not return_intermediates
            and kernels and single):
        pool = gcn_local_model_slots(**slot_kernel_operands(params, batch, prec))
        return _base.pool_finish(pool, batch, params["pred_b"], prec)

    h = atom_embed(params["node_embedding"], batch["node_feat"], prec)
    inter = [h]
    if ell:
        a = _ell_layers(params, batch, prec, h, inter, edge_axis)
    else:
        L = params["conv_w"].shape[0]
        u, v = batch["senders"].long(), batch["receivers"].long()
        deg = out_degree(batch, edge_axis).to(prec.compute_dtype)
        dis = 1.0 / torch.sqrt(deg + 1)
        # dis is the same every layer: on a halo shard one exchange covers them all.
        norm = prec.q(_norms(dis, batch, edge_axis, u, v))
        m = torch.zeros_like(h)
        for l in range(L):
            a = h if l == 0 else relu(_tail(params, m, h, deg, l - 1, prec))
            h = linear(a, params["conv_w"][l], params["conv_b"][l], prec)
            ee = bond_embed(params["edge_embedding"][l], batch["edge_attr"], prec)
            msg = norm * relu(gather_sources(h, batch, edge_axis) + ee)
            m = prec.q(edge_segment_sum(msg, batch, edge_axis))
            inter.append(h)
        # The final tail has no ReLU (GCN/src/finalize.cc:88-96).
        a = _tail(params, m, h, deg, L - 1, prec)
    h_graph = mean_pool(a, batch, prec, edge_axis)
    out = linear(h_graph, params["pred_w"], params["pred_b"], prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
