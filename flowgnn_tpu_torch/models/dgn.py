"""DGN over packed batches (mean + directional-derivative channels, dim 100).

The counterpart of ``flowgnn_tpu.models.dgn.forward``. Math (see
``flowgnn_tpu/reference/oracles.py:dgn_forward`` for citations): two-channel
messages m1 = Σ h_u and m2 = Σ (eig_u − eig_v)·h_u over in-edges, with eig
the Laplacian eigenvector's component [1] (DGN/src/message_passing.cc:
120-153, DGN/src/load_inputs.cc:105-110); a1 = m1/deg, a2 = |m2 −
eigw_sum·h| / eig_abssum (zero → the ap_fixed<16,3> ulp); a [dim, 2, dim]
posttrans linear; residual h + relu(acc) (DGN/src/node_embedding.cc:
107-160); readout MLP dim → 50 → 25 → 1 (DGN/src/finalize.cc:35-52).

Two branches: a slot batch runs the whole conv stack and readout MLP-1 in one
``dgn_local_model`` launch, then MLP-2/3 in plain torch; a plain edge-list
batch runs the plain loop, the port's own oracle. A slot batch the
megakernel does not take would go to the per-layer kernel
``dgn_local_layer_slots`` in the JAX package (kernel table row 22, not
ported yet) and raises ``NotImplementedError``, as do the ELL layouts.
"""

from __future__ import annotations

import torch

from ..core.features import ATOM_FEATURE_DIMS
from ..core.numerics import FLOAT32, Precision
from ..ops.local_layer import dgn_local_model
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


def _node_terms(batch: dict, prec: Precision):
    """(eig, eig_w, eigw_sum, eig_abssum, deg) in the compute dtype: eig
    [n], eig_w = eig_u − eig_v per edge, the per-node sums of eig_w and
    |eig_w| over in-edges (host-precomputed in f32 on slot batches, as the
    JAX package does), the abssum's zero replaced by EIG_EPS, and the
    out-degree clamped to 1 as [n, 1]."""
    dt = prec.compute_dtype
    u, v = batch["senders"].long(), batch["receivers"].long()
    n = _base.num_nodes_static(batch)
    eig = batch["node_eigen"][:, 1].to(dt)
    eig_w = eig[u] - eig[v]
    if "eigw_sum" in batch:
        eigw_sum = batch["eigw_sum"].to(dt)
        eig_abssum = batch["eig_abssum"].to(dt)
    else:
        eig_abssum = segment_sum(eig_w.abs(), v, n)
        eigw_sum = segment_sum(eig_w, v, n)
    eig_abssum = torch.where(eig_abssum == 0, EIG_EPS, eig_abssum)
    # The device divides by the raw out-degree with no zero guard
    # (DGN/src/node_embedding.cc:145), a reference quirk kept here; the
    # clamp covers isolated nodes, whose message is 0.
    deg = torch.clamp_min(out_degree(batch), 1).to(dt)[:, None]
    return eig, eig_w, eigw_sum, eig_abssum, deg


def slot_kernel_operands(params: dict, batch: dict, prec: Precision = FLOAT32) -> dict:
    """The keyword operands the slot branch hands ``dgn_local_model`` for a
    slot batch (also used to time the kernel on its own). The per-node terms
    are in the compute dtype, as the TPU kernel's feature tile carries
    them."""
    dt = prec.compute_dtype
    L, d = params["posttrans_w"].shape[:2]
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    eig, _, eigw_sum, eig_abssum, deg = _node_terms(batch, prec)
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
    )


def _readout_tail(z: torch.Tensor, params: dict, prec: Precision) -> torch.Tensor:
    """ReLU, then readout MLP-2 and MLP-3."""
    z = relu(linear(relu(z), params["mlp2_w"], params["mlp2_b"], prec))
    return linear(z, params["mlp3_w"], params["mlp3_b"], prec)


def forward(
    params: dict,
    batch: dict,
    prec: Precision = FLOAT32,
    return_intermediates: bool = False,
):
    """[G+1, 1] predictions (the last row is the pad graph's). ``params``
    as made by ``params.loaders.params_from_numpy``; ``batch`` as made by
    ``models.base.to_device`` from a packing with ``with_eigen=True``."""
    _base.reject_unported_layouts(batch)
    if "slot_src" in batch:
        if batch["slot_spill"].shape[-1]:
            raise NotImplementedError(
                "slot batch with a spill tail: dgn_local_layer_slots (kernel table "
                "row 22) is not ported yet (ROADMAP queue 1 item 9)"
            )
        if return_intermediates or "pool_gl" not in batch:
            raise NotImplementedError(
                "a slot batch without the megakernel (return_intermediates, or "
                f"more than POOL_GMAX={_base.POOL_GMAX} graphs in a window) runs "
                "dgn_local_layer_slots (kernel table row 22), not ported yet "
                "(ROADMAP queue 1 item 9)"
            )
        pool = dgn_local_model(**slot_kernel_operands(params, batch, prec))
        return _readout_tail(_base.pool_finish(pool, batch, params["mlp1_b"], prec), params, prec)

    L = params["posttrans_w"].shape[0]
    eig, eig_w, eigw_sum, eig_abssum, deg = _node_terms(batch, prec)
    h = _atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec)
    inter = [h]
    for l in range(L):
        x = gather_sources(h, batch)
        d = x.shape[1]
        mm = edge_segment_sum(torch.cat([x, eig_w[:, None] * x], dim=1), batch)
        m1, m2 = mm[:, :d], mm[:, d:]
        a1 = m1 / deg
        a2 = (m2 - eigw_sum[:, None] * h).abs() / eig_abssum[:, None]
        # One linear over both channels: the [dim_out, 2·dim_in] posttrans.
        w = params["posttrans_w"][l].reshape(d, 2 * d)
        acc = linear(torch.cat([a1, a2], dim=1), w, params["posttrans_b"][l], prec)
        h = h + relu(acc)
        inter.append(h)
    h_graph = mean_pool(h, batch)
    out = _readout_tail(linear(h_graph, params["mlp1_w"], params["mlp1_b"], prec), params, prec)
    if return_intermediates:
        return out, {"layers": inter, "h_graph": h_graph}
    return out
