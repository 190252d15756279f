"""DGN over packed batches (mean + directional-derivative channels, dim 100).

The counterpart of ``flowgnn_tpu.models.dgn.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:dgn_forward`` for citations): two-channel
messages m1 = Σ h_u and m2 = Σ (eig_u − eig_v)·h_u over in-edges, with eig
the Laplacian eigenvector's component [1] (DGN/src/message_passing.cc:
120-153, DGN/src/load_inputs.cc:105-110); a1 = m1/deg, a2 = |m2 −
eigw_sum·h| / eig_abssum (zero → the ap_fixed<16,3> ulp); a [dim, 2, dim]
posttrans linear; residual h + relu(acc) (DGN/src/node_embedding.cc:
107-160); readout MLP dim → 50 → 25 → 1 (DGN/src/finalize.cc:35-52).

Four branches: a slot batch with no spill tail (at any window of 128 to 1024
rows) runs the whole conv stack and readout MLP-1 in one ``dgn_local_model``
launch, then MLP-2/3 in plain torch; any other slot batch (a spill tail,
``return_intermediates``, no ``pool_gl``) runs the per-layer slot path, as
the JAX package does: per layer one ``dgn_local_layer_slots`` launch (kernel
table row 22: one layer of row 4's kernel, at any window of 128 to 1024
rows, its bf16 posttrans chunks packed once per weight set for all layers
and handed out layer by layer), which takes the spill tail's two channels
pre-reduced through ``base.spill_segment_sum`` (row 24), then ``mean_pool``
and the readout in plain torch; an ELL batch runs the per-layer ELL path
(``flowgnn_tpu/models/dgn.py:166-214``): with no spill tail one
``dgn_local_layer_ell`` launch per layer (row 18), with one per layer
``dgn_local_message_ell`` (row 16) for the window-local channels, the tail's
channels through ``base.ell_spill_segment_sum`` (row 24), and a1, a2, the
posttrans and the residual in plain torch; a plain edge-list batch runs the
plain loop, the port's own oracle.

Sharded (``edge_axis``, ``parallel.inference``), with the JAX package's
gates (``flowgnn_tpu/models/dgn.py:56-232``): on a halo shard eig is
exchanged once for all layers and the two per-node eig sums reduce
rank-locally into the trash row; a slot shard with no spill tail runs the
slot branches above per shard (row 4, its pool partials completed by
``base.pool_gather``, or row 22 per layer), an ELL shard rows 18 or 16 per
layer, its spill tail's channels gathered from the layer's exchanged rows
(issued before row 16, waited on after it) and summed into the trash row,
not through row 24; a slot shard with a spill tail, and every other sharded
batch, runs the plain loop, its gathers through the halo exchange or its
sums completed over the axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.features import ATOM_FEATURE_DIMS
from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import (
    dgn_local_layer_ell, dgn_local_layer_slots, dgn_local_message_ell, dgn_local_model,
    dgn_posttrans_tiles,
)
from ..ops.segment import segment_sum
from . import base as _base
from .base import edge_segment_sum, gather_sources, linear, mean_pool, out_degree, relu

EIG_EPS = 1.0 / 8192  # ap_fixed_epsilon<ap_fixed<16,3>> (DGN/src/node_embedding.cc:125)


def _atom_embed_dgn(tables: torch.Tensor, node_feat: torch.Tensor, prec: Precision):
    """DGN keeps 9 separate [119, dim] tables (DGN/src/load_inputs.cc:
    114-137); their used rows, concatenated, are the compact [173, dim]
    table the other models' ``atom_embed`` reads, with the same sum."""
    compact = torch.cat([tables[i, :v] for i, v in enumerate(ATOM_FEATURE_DIMS)])
    return _base.atom_embed(compact, node_feat, prec)


def _node_terms(batch: dict, prec: Precision, axis=None):
    """(eig, eig_w, eigw_sum, eig_abssum, deg) in the compute dtype: eig
    [n], eig_w = eig_u − eig_v per edge, the per-node sums of eig_w and
    |eig_w| over in-edges (host-precomputed in f32 on slot batches, as the
    JAX package does, except in the fixed mode, which sums the quantized
    eig_w), the abssum's zero replaced by EIG_EPS, and the out-degree
    clamped to 1 as [n, 1]. eig_w, eigw_sum and eig_abssum are quantized
    (``prec.q``). On a halo shard (``axis``) eig_u comes from the extended
    rows (one exchange), a pad lane's eig_v from the trash row, and the sums
    run over the shard's n + 1 rows; with the edges split over ``axis`` the
    sums and degrees are completed over it."""
    dt = prec.compute_dtype
    u, v = batch["senders"].long(), batch["receivers"].long()
    n = _base.num_nodes_static(batch)
    eig = batch["node_eigen"][:, 1].to(dt)
    eig_u = _base.sender_rows(eig[:, None], batch, axis)[:, 0]
    eig_w = prec.q(eig_u[u] - _base.receiver_rows(eig, batch, axis)[v])
    if "eigw_sum" in batch and prec.fixed is None and axis is None:
        eigw_sum = batch["eigw_sum"].to(dt)
        eig_abssum = batch["eig_abssum"].to(dt)
    else:
        rows, red = _base.receiver_space(batch, axis)
        eig_abssum = segment_sum(eig_w.abs(), v, rows, red)[:n]
        eigw_sum = prec.q(segment_sum(eig_w, v, rows, red)[:n])
    eig_abssum = prec.q(torch.where(eig_abssum == 0, EIG_EPS, eig_abssum))
    # The device divides by the raw out-degree with no zero guard
    # (DGN/src/node_embedding.cc:145), a reference quirk kept here; the
    # clamp covers isolated nodes, whose message is 0.
    deg = torch.clamp_min(out_degree(batch, axis), 1).to(dt)[:, None]
    return eig, eig_w, eigw_sum, eig_abssum, deg


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32,
                         axis=None) -> dict:
    """The keyword operands the slot branch hands ``dgn_local_model`` for a
    slot batch (also used to time the kernel on its own). The per-node terms
    are in the compute dtype, as the TPU kernel's feature tile carries
    them; ``axis``: the edge axis of a halo shard."""
    dt = prec.compute_dtype
    L, d = params["posttrans_w"].shape[:2]
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    eig, _, eigw_sum, eig_abssum, deg = _node_terms(batch, prec, axis)
    # Per layer [2D, D]: the [dim_out, 2·dim_in] posttrans, right-multiplied.
    w_all = params["posttrans_w"].reshape(L, d, 2 * d).transpose(1, 2).reshape(L * 2 * d, d)
    w_all = w_all.contiguous()
    return dict(
        slot_src=batch["slot_src"],
        h0=_atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec),
        eig=eig.contiguous(), inv_deg=(1.0 / deg)[:, 0], eigw_sum=eigw_sum,
        inv_abssum=1.0 / eig_abssum, w_all=w_all, b_all=params["posttrans_b"],
        pool_gl=batch["pool_gl"], mlp1_w=params["mlp1_w"].T.to(dt).contiguous(),
        window=window, slots=n_slots, num_layers=L, gmax=_base.POOL_GMAX,
        prefix_caps=_base.slot_prefix_caps(batch, n_slots),
        posttrans_tiles=posttrans_tiles(params, prec),
    )


def posttrans_tiles(params: dict, prec: Precision) -> Optional[torch.Tensor]:
    """The bf16 slot megakernel's posttrans weight chunks of every layer
    (``ops.local_layer.dgn_posttrans_tiles`` over ``posttrans_w`` viewed as
    [L, D_out, 2·D_in]: packed once per weight set, and again after an
    in-place update of the weights); None outside bf16, where the kernel
    reads ``w_all`` as it is."""
    if prec.compute_dtype != torch.bfloat16:
        return None
    L, d = params["posttrans_w"].shape[:2]
    return dgn_posttrans_tiles(params["posttrans_w"].reshape(L, d, 2 * d))


def _channels(x: torch.Tensor, eig_w: torch.Tensor) -> torch.Tensor:
    """The two message channels [x ‖ eig_w·x] of the lanes' h_u ``x`` and
    eig_u − eig_v ``eig_w``."""
    return torch.cat([x, eig_w[:, None] * x], dim=1)


def spill_values(h: torch.Tensor, batch: dict, eig: torch.Tensor, lanes) -> torch.Tensor:
    """The spill lanes' two channels [h_u ‖ (eig_u − eig_v)·h_u] (pad lanes
    weigh 0: both their ends are the pad node)."""
    sp_u, sp_v = lanes
    return _channels(_base.spill_gather(h, sp_u), eig[sp_u] - eig[sp_v])


def _layer_terms(params: dict, l: int, d: int, terms) -> dict:
    """Layer ``l``'s node terms and posttrans as the per-layer kernels take
    them (``terms`` as ``_node_terms`` gives them)."""
    eig, _, eigw_sum, eig_abssum, deg = terms
    return dict(
        eig=eig.contiguous(), inv_deg=(1.0 / deg)[:, 0], eigw_sum=eigw_sum,
        inv_abssum=1.0 / eig_abssum,
        # [2D, D]: the [dim_out, 2·dim_in] posttrans, right-multiplied.
        w_post=params["posttrans_w"][l].reshape(d, 2 * d).T.contiguous(),
        b_post=params["posttrans_b"][l][None, :],
    )


def layer_operands(params: dict, batch: dict, l: int, h: torch.Tensor, terms, lanes,
                   tiles: Optional[torch.Tensor] = None) -> dict:
    """The keyword operands the per-layer slot path hands
    ``dgn_local_layer_slots`` for layer ``l`` and its input ``h``
    (``terms`` as ``_node_terms`` gives them); with a spill tail (``lanes``
    as ``base.spill_lanes`` gives them, else None), ``m_spill`` is the
    tail's two channels summed per node (``base.spill_segment_sum``).
    ``tiles``: every layer's bf16 posttrans chunks as ``posttrans_tiles``
    gives them, of which layer ``l``'s are handed over, or None."""
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    m_spill = None
    if lanes is not None:
        m_spill = _base.spill_segment_sum(spill_values(h, batch, terms[0], lanes), batch,
                                          lanes[1])
    return dict(slot_src=batch["slot_src"], h=h, window=window, slots=n_slots, m_spill=m_spill,
                posttrans_tiles=None if tiles is None else tiles[l],
                **_layer_terms(params, l, h.shape[1], terms))


def ell_layer_operands(params: dict, batch: dict, l: int, h: torch.Tensor, terms, meta,
                       spill, tiles: Optional[torch.Tensor] = None) -> dict:
    """The keyword operands the per-layer ELL path hands
    ``dgn_local_layer_ell`` (no spill tail: ``spill`` None) or
    ``dgn_local_message_ell`` (a spill tail) for layer ``l`` and its input
    ``h``; ``meta`` is ``base.ell_meta(batch)``. ``tiles``: every layer's
    bf16 posttrans chunks as ``posttrans_tiles`` gives them (row 22's), of
    which ``dgn_local_layer_ell`` is handed layer ``l``'s, or None."""
    ops = dict(ell_meta=meta, h=h, eig=terms[0].contiguous(),
               window=_base.ell_geometry(batch)[0])
    if spill is not None:
        return ops
    return dict(ops, posttrans_tiles=None if tiles is None else tiles[l],
                **_layer_terms(params, l, h.shape[1], terms))


def layer_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """Layer 0's keyword operands of the kernels the per-layer paths run, by
    wrapper name (also used to check and time the kernels on their own):
    ``dgn_local_layer_slots`` (and the spill scatter with a spill tail) on a
    slot batch; on an ELL batch ``dgn_local_layer_ell`` with no spill tail,
    ``dgn_local_message_ell`` and the spill scatter with a blocked one; on
    an edge-block batch (``as_batch(blocked=True)``) the windowed scatter of
    the plain loop's [h_u ‖ (eig_u − eig_v)·h_u]."""
    h = _atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec)
    terms = _node_terms(batch, prec)
    if "blk_vlocal" in batch:
        x = gather_sources(h, batch)
        return {"windowed_segment_sum": _base.blocked_segment_operands(
            _channels(x, terms[1]), batch)}
    if "loc_ell" in batch:
        spill = _base.ell_spill(batch)
        ops = ell_layer_operands(params, batch, 0, h, terms, _base.ell_meta(batch), spill,
                                 posttrans_tiles(params, prec))
        if spill is None:
            return {"dgn_local_layer_ell": ops}
        out = {"dgn_local_message_ell": ops}
        if "spill_blk_vlocal" in batch:
            out["windowed_segment_sum"] = _base.spill_segment_operands(
                spill_values(h, batch, terms[0], spill[:2]), batch)
        return out
    lanes = _base.spill_lanes(batch) if batch["slot_spill"].shape[-1] else None
    out = {"dgn_local_layer_slots": layer_operands(params, batch, 0, h, terms, lanes,
                                                   posttrans_tiles(params, prec))}
    if lanes is not None:
        out["windowed_segment_sum"] = _base.spill_segment_operands(
            spill_values(h, batch, terms[0], lanes), batch)
    return out


def _readout_tail(z: torch.Tensor, params: dict, prec: Precision) -> torch.Tensor:
    """ReLU, then readout MLP-2 and MLP-3."""
    z = relu(linear(relu(z), params["mlp2_w"], params["mlp2_b"], prec))
    return linear(z, params["mlp3_w"], params["mlp3_b"], prec)


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
    edge_axis=None,
):
    """[G+1, 1] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device`` from a packing with ``with_eigen=True``. In
    the fixed mode (``prec.fixed``) every batch runs the plain loop, with
    ``prec.q`` at the JAX package's stage boundaries. ``edge_axis``: the
    mesh axis over which the batch is sharded (``parallel.inference``);
    None on one device."""
    kernels = prec.fixed is None
    halo = _base.halo_mode(batch, edge_axis)
    single = edge_axis is None
    slots = "slot_src" in batch and kernels and (
        single or (halo and not batch["slot_spill"].shape[-1]))
    if (
        slots and not batch["slot_spill"].shape[-1] and not return_intermediates
        and "pool_gl" in batch
    ):
        pool = dgn_local_model(**slot_kernel_operands(params, batch, prec, edge_axis))
        pool = _base.pool_gather(pool, edge_axis)
        return _readout_tail(_base.pool_finish(pool, batch, params["mlp1_b"], prec), params, prec)

    L = params["posttrans_w"].shape[0]
    terms = _node_terms(batch, prec, edge_axis)
    eig, eig_w, eigw_sum, eig_abssum, deg = terms
    h = _atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec)
    lanes = _base.spill_lanes(batch) if slots and batch["slot_spill"].shape[-1] else None
    ell = "loc_ell" in batch and kernels and (single or halo)
    if ell:
        meta, spill = _base.ell_meta(batch), _base.ell_spill(batch)
    # Rows 22 and 18 (an ELL batch with no spill tail) take the bf16 chunks.
    tiles = posttrans_tiles(params, prec) if slots or (ell and spill is None) else None
    inter = [h]
    for l in range(L):
        if slots:
            h = dgn_local_layer_slots(**layer_operands(params, batch, l, h, terms, lanes, tiles))
            inter.append(h)
            continue
        d = h.shape[1]
        if ell:
            ops = ell_layer_operands(params, batch, l, h, terms, meta, spill, tiles)
            if spill is None:
                h = dgn_local_layer_ell(**ops)
                inter.append(h)
                continue
            # The spill lanes are the edges past the P local lanes.
            src = _base.sender_rows(h, batch, edge_axis, wait=False)
            m_loc = dgn_local_message_ell(**ops)
            tail = _channels(_base.spill_gather(src(), spill[0]),
                             eig_w[batch["loc_ulocal"].shape[0]:])
            m_spill = _base.ell_spill_segment_sum(tail, batch)
            m1, m2 = m_loc[:, :d] + m_spill[:, :d], m_loc[:, d:] + m_spill[:, d:]
        else:
            x = gather_sources(h, batch, edge_axis)
            mm = edge_segment_sum(_channels(x, eig_w), batch, edge_axis)
            m1, m2 = mm[:, :d], mm[:, d:]
        m1, m2 = prec.q(m1), prec.q(m2)
        a1 = prec.q(m1 / deg)
        a2 = prec.q((m2 - eigw_sum[:, None] * h).abs() / eig_abssum[:, None])
        # One linear over both channels: the [dim_out, 2·dim_in] posttrans.
        w = params["posttrans_w"][l].reshape(d, 2 * d)
        acc = linear(torch.cat([a1, a2], dim=1), w, params["posttrans_b"][l], prec)
        h = prec.q(h + relu(acc))
        inter.append(h)
    h_graph = mean_pool(h, batch, prec, edge_axis)
    out = _readout_tail(linear(h_graph, params["mlp1_w"], params["mlp1_b"], prec), params, prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
