"""Shared model building blocks over packed graph batches.

Host half (numpy): window geometry and ``as_batch``, which turns a
``PackedGraphs`` bucket into a dict of numpy arrays, plus ``to_device``,
which moves such a dict onto a torch device. Device half (torch): the
embedding, gather, segment and pooling helpers the models run around the
kernels.

A batch is the dict-of-arrays view of ``core.graphs.PackedGraphs``:

  node_feat  [N+1, 9] i32   node_graph [N+1] i32   senders/receivers [E] i32
  edge_attr  [E, 3]   i32   n_node/n_edge [G+1] i32   node_eigen [N+1, 4] f32?
  vn_mask    [N+1] bool?

with one trailing pad node (index N) that every padded edge points at and one
trailing pad graph that owns every pad node. ``blocked="local_slots"`` adds
the degree-sorted dest-major slot layout of the slot megakernels, and
``blocked="local_ell"`` the ELL layout of the whole-model ELL kernels. Their
arrays hold the same values as ``flowgnn_tpu.models.base.as_batch`` builds,
stored as int32 where the JAX package stores bfloat16; static geometry rides
in the shapes of the marker arrays ``slot_pcap_k``, ``slot_geom`` and
``loc_ell``.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.features import BOND_FEATURE_OFFSETS
from ..core.graphs import PackedGraphs
from ..core.numerics import Precision
from ..ops.segment import segment_sum

# Window and ELL block per model. The slot megakernels read only the window;
# the block is the ELL lanes per window. Both are the port's own: W=128 keeps
# a window's f32 state inside one Hopper block's shared memory (the JAX
# package's v5e table puts GIN-VN at W=256 and GAT at W=384, figures of that
# chip's 128-lane tiles); the ELL kernels span larger windows with a cluster
# of 128-row blocks.
GEOMETRY_DEFAULTS: dict[str, tuple[int, int]] = {
    "gin": (128, 384),
    "gin-vn": (128, 384),
    "gcn": (128, 384),
    "gat": (128, 384),
    "pna": (128, 384),
    "dgn": (128, 384),
}
MAX_SLOTS = 8  # deepest slot axis; deeper in-degrees would spill
POOL_GMAX = 64  # graph slots per window in the in-kernel pooling layout


def choose_window(model: str, max_graph_nodes: int, default_w: int) -> int:
    """The default window, bumped to the smallest of 256/384/512 that holds
    the stream's largest graph, so that no graph spills."""
    if max_graph_nodes > default_w:
        for w in (256, 384, 512):
            if w >= default_w and w >= max_graph_nodes:
                return w
    return default_w


def choose_geometry(model: str, max_graph_nodes: int) -> tuple[int, int]:
    """(window, block) for a stream: the per-model default with the window
    bumped by ``choose_window`` and the block scaled with it."""
    gw, gb = GEOMETRY_DEFAULTS[model]
    w = choose_window(model, max_graph_nodes, gw)
    b = gb
    if w != gw:
        b = -(-(gb * w) // (gw * 128)) * 128
    return w, b


def slot_prefix_caps(batch: dict, n_slots: int):
    """Static per-slot prefix caps (degree-sorted layout) or None; they ride
    in the marker arrays' shapes."""
    if "slot_pcap_0" not in batch:
        return None
    return tuple(
        int(batch[f"slot_pcap_{k}"].shape[-2]) for k in range(n_slots)
    )


def pool_layout(
    ids: np.ndarray, num_graphs: int, window: int
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(pool_gl, pool_row) of the in-kernel finalize layout over a padded
    node-graph-id axis, or None when a window holds more than POOL_GMAX
    graphs. pool_gl is each row's graph id relative to the window's first
    graph (sentinel POOL_GMAX for padding rows); pool_row is each graph's
    row in the kernel's [NW·GMAX, T] pool output."""
    n = ids.shape[0]
    num_windows = -(-n // window)
    real = ids < num_graphs - 1  # gap/pad rows carry the pad-graph id
    win = np.arange(n) // window
    big = np.iinfo(np.int32).max
    gbase = np.full(num_windows, big, np.int64)
    np.minimum.at(gbase, win[real], ids[real])
    gbase[gbase == big] = 0  # all-padding windows
    gl = np.full(num_windows * window, POOL_GMAX, np.int64)
    gl[: n][real] = ids[real] - gbase[win[real]]
    if real.any() and gl[: n][real].max() >= POOL_GMAX:
        return None
    first = np.full(num_graphs, n - 1, np.int64)
    np.minimum.at(first, ids, np.arange(n))
    w_of_g = first // window
    row = w_of_g * POOL_GMAX + (np.arange(num_graphs) - gbase[w_of_g])
    # The pad graph and empty graphs get garbage slots (clamped into range).
    return (
        gl.astype(np.int32),
        np.clip(row, 0, num_windows * POOL_GMAX - 1).astype(np.int32),
    )


def _pad_rows(arr: np.ndarray, rows: int, fill=0) -> np.ndarray:
    out = np.full((rows,) + arr.shape[1:], fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _window_degree_perm(
    senders: np.ndarray, receivers: np.ndarray, n: int, window: int
) -> np.ndarray:
    """Permutation of the padded node axis that sorts each window's rows by
    local in-degree, descending (stable). Real rows precede the window's
    phantom padding and the trailing pad node stays at index n−1. Returns
    perm over [0, NW·window) with new_row r ← old_row perm[r]."""
    num_windows = -(-n // window)
    rows = num_windows * window
    real_e = receivers < n - 1
    loc = real_e & (senders // window == receivers // window)
    deg = np.bincount(receivers[loc], minlength=rows).astype(np.int64)
    pos = np.arange(rows, dtype=np.int64)
    key_deg = deg.copy()
    key_deg[n - 1] = -1  # the pad node: last real row of its window
    key_deg[n:] = -2  # phantom padding rows: after every real row
    order = np.lexsort((pos, -key_deg, pos // window))
    return order.astype(np.int64)


def _attach_pool_layout(batch: dict, packed: PackedGraphs, window: int, ids) -> None:
    """Attach pool_gl / pool_row, or leave them out with a warning when a
    window holds more than POOL_GMAX graphs (the models then raise)."""
    out = pool_layout(np.asarray(ids), packed.n_node.shape[0], window)
    if out is None:
        warnings.warn(
            f"window of {window} holds more than POOL_GMAX={POOL_GMAX} "
            "graphs; in-kernel pooling disabled for this bucket",
            stacklevel=3,
        )
        return
    batch["pool_gl"], batch["pool_row"] = out


def _attach_degrees(batch: dict, n: int) -> None:
    """Host-precomputed in/out degree tables (graph constants), and with
    eigenvectors DGN's per-node sums of eig_u − eig_v and |eig_u − eig_v|
    over in-edges, in float32 as the reference's load stage computes them
    (DGN/src/load_inputs.cc:105-110)."""
    batch["out_deg"] = np.bincount(batch["senders"], minlength=n).astype(np.int32)
    batch["in_deg"] = np.bincount(batch["receivers"], minlength=n).astype(np.int32)
    if "node_eigen" in batch:
        eig = batch["node_eigen"][:, 1].astype(np.float32)
        ew = eig[batch["senders"]] - eig[batch["receivers"]]
        s = np.zeros(n, np.float32)
        np.add.at(s, batch["receivers"], ew)
        a = np.zeros(n, np.float32)
        np.add.at(a, batch["receivers"], np.abs(ew))
        batch["eigw_sum"] = s
        batch["eig_abssum"] = a


def as_batch(
    packed: PackedGraphs, blocked=False, window: int | None = None,
    block: int | None = None, *, slots: int | None = None, prefix_caps=None,
) -> dict:
    """PackedGraphs → dict of numpy arrays.

    ``blocked=False`` gives the plain edge-list batch. ``blocked=
    "local_slots"`` (needs window-aligned packing) re-orders each window's
    rows by local in-degree and attaches the dest-major slot layout:
    ``slot_meta`` [NW·Σc, 4] holds, per prefix lane, (src − W/2, the three
    bond attrs with their vocabulary offsets); empty lanes carry src = W − W/2
    and attrs −1. ``slots`` / ``prefix_caps`` pin the slot depth and per-slot
    caps so that every bucket of a stream shares one layout
    (``as_batches_uniform``). ``blocked="local_ell"`` (window-aligned
    packing too) keeps the node order and attaches the ELL layout of
    ``window`` rows and ``block`` lanes per edge block (see
    ``_attach_ell_layout``). Buckets whose edges spill (window-crossing
    edges, in-degree above the slot depth, or more local edges than a
    window's ELL lanes) raise: the spill tail is not ported, nor are the
    legacy ``"local"`` and edge-block layouts (ROADMAP queue 2).
    """
    batch = {
        "node_feat": packed.node_feat,
        "node_graph": packed.node_graph,
        "senders": packed.senders,
        "receivers": packed.receivers,
        "edge_attr": packed.edge_attr,
        "n_node": packed.n_node,
        "n_edge": packed.n_edge,
    }
    if packed.node_eigen is not None:
        batch["node_eigen"] = packed.node_eigen
    if packed.node_vn is not None:
        batch["vn_mask"] = packed.node_vn
    if not blocked:
        return batch
    if blocked == "local_ell":
        gw, gb = GEOMETRY_DEFAULTS["gin"]
        _attach_ell_layout(batch, packed, window or gw, block or gb)
        return batch
    if blocked != "local_slots":
        raise NotImplementedError(
            f"blocked={blocked!r} is not ported yet (ROADMAP queue 2 C)"
        )
    from ..core.blocking import build_local_slots

    n = packed.node_capacity + 1
    w = window or GEOMETRY_DEFAULTS["gin"][0]
    senders = np.asarray(packed.senders)
    receivers = np.asarray(packed.receivers)
    node_perm = _window_degree_perm(senders, receivers, n, w)
    inv = np.empty_like(node_perm)
    inv[node_perm] = np.arange(node_perm.shape[0])
    nw_rows = node_perm.shape[0]  # NW·W (≥ n)
    batch["node_feat"] = _pad_rows(packed.node_feat, nw_rows)[node_perm][:n]
    batch["node_graph"] = _pad_rows(
        packed.node_graph, nw_rows, fill=int(packed.n_node.shape[0] - 1)
    )[node_perm][:n]
    if packed.node_eigen is not None:
        batch["node_eigen"] = _pad_rows(packed.node_eigen, nw_rows)[node_perm][:n]
    if packed.node_vn is not None:
        batch["vn_mask"] = _pad_rows(packed.node_vn, nw_rows)[node_perm][:n]
    senders = inv[senders].astype(np.int32)
    receivers = inv[receivers].astype(np.int32)
    batch["senders"], batch["receivers"] = senders, receivers

    real = receivers < n - 1
    loc = real & (senders // w == receivers // w)
    s_needed = int(
        np.bincount(receivers[loc], minlength=n).max()
    ) if loc.any() else 1
    s_slots = slots or max(1, min(s_needed, MAX_SLOTS))
    slot_src, spill, count, slot_edge = build_local_slots(
        senders, receivers, n, window=w, slots=s_slots,
    )
    if count:
        raise NotImplementedError(
            f"{count} edges spill out of the slot layout; the spill tail is "
            "not ported yet (ROADMAP queue 2 B)"
        )
    batch["slot_src"] = slot_src  # [NW·W, S]
    nw = slot_src.shape[0] // w
    slot3 = slot_src.reshape(nw, w, s_slots)
    batch["slot_stack"] = np.ascontiguousarray(slot3.transpose(0, 2, 1)).reshape(-1)
    # Prefix-compacted layout: slot k's real lanes are rows [0, c_k) of each
    # window; the static caps are the max occupancy over windows, rounded
    # up to 64 rows (the JAX package's floor, kept for equal layouts).
    occ = (slot3 < w).sum(axis=1)  # [NW, S]
    caps = np.minimum(-(-occ.max(axis=0) // 64) * 64, w)
    caps = np.maximum(caps, 64)
    if prefix_caps is not None:
        pinned = np.asarray(prefix_caps, np.int64)
        if (pinned < occ.max(axis=0)).any():
            raise ValueError(
                "pinned prefix_caps below this bucket's slot "
                f"occupancy ({tuple(pinned)} < "
                f"{tuple(occ.max(axis=0))}) — would drop edges"
            )
        caps = np.minimum(pinned, w)
    m_rows = int(caps.sum())
    pstack = np.full((nw, m_rows), w, np.int32)
    half = w // 2 if w <= 512 else 0
    meta = np.full((nw, m_rows, 4), -1, np.int32)
    ea_off = np.asarray(batch["edge_attr"]) + BOND_FEATURE_OFFSETS[None, :]
    off = 0
    for k in range(s_slots):
        c = int(caps[k])
        pstack[:, off : off + c] = slot3[:, :c, k]
        se = slot_edge.reshape(nw, w, s_slots)[:, :c, k]
        vmask = se >= 0
        meta[:, off : off + c, 1:][vmask] = ea_off[se[vmask]]
        off += c
    meta[:, :, 0] = pstack - half
    batch["slot_pstack"] = pstack.reshape(-1)
    for k in range(s_slots):
        batch[f"slot_pcap_{k}"] = np.zeros((int(caps[k]), 1), np.int8)
    batch["slot_meta"] = meta.reshape(-1, 4)
    batch["slot_spill"] = spill
    batch["slot_spill_mask"] = np.zeros(0, bool)
    # Shape carries (window, slots) to the model.
    batch["slot_geom"] = np.zeros((w, s_slots), np.int32)
    _attach_pool_layout(batch, packed, w, batch["node_graph"])
    _attach_degrees(batch, n)
    return batch


def _attach_ell_layout(batch: dict, packed: PackedGraphs, window: int, block: int) -> None:
    """The no-spill ELL layout of ``flowgnn_tpu.models.base.as_batch``:
    ``senders`` / ``receivers`` / ``edge_attr`` re-ordered into the
    NW·k·block lanes (pad lanes point at the pad node, attrs 0),
    ``loc_ulocal`` / ``loc_vlocal`` the lanes' in-window endpoints, the
    ``loc_ell`` marker whose shape (window, k) carries the geometry, the
    pooling layout over the un-permuted ``node_graph``, and the degree
    tables."""
    from ..core.blocking import build_local_blocks_ell

    n = packed.node_capacity + 1
    lb = build_local_blocks_ell(packed.senders, packed.receivers, n, window=window, block=block)
    if lb.spill_count:
        raise NotImplementedError(
            f"{lb.spill_count} edges spill out of the ELL layout; the spill tail "
            "(_attach_spill_blocks and kernel table rows 13 / 15 / 24) is not "
            "ported yet (ROADMAP queue 2 B)"
        )
    lanes = lb.u_local.shape[0]
    s = np.full(lanes, n - 1, np.int32)
    r = np.full(lanes, n - 1, np.int32)
    a = np.zeros((lanes, packed.edge_attr.shape[1]), np.int32)
    take = lb.edge_perm[lb.valid]
    s[lb.valid] = packed.senders[take]
    r[lb.valid] = packed.receivers[take]
    a[lb.valid] = packed.edge_attr[take]
    batch["senders"], batch["receivers"], batch["edge_attr"] = s, r, a
    batch["loc_ulocal"] = lb.u_local
    batch["loc_vlocal"] = lb.v_local
    batch["loc_ell"] = np.zeros((lb.window, lb.k_blocks), np.int32)
    _attach_pool_layout(batch, packed, lb.window, packed.node_graph)
    _attach_degrees(batch, n)


def ell_geometry(batch: dict) -> tuple[int, int]:
    """(window, k_blocks) of an ELL batch, from the ``loc_ell`` marker's
    trailing two dims."""
    m = batch["loc_ell"]
    return int(m.shape[-2]), int(m.shape[-1])


def require_ell_megakernel(batch: dict, return_intermediates: bool, layer_row: int) -> None:
    """Pass an ELL batch that a whole-model ELL kernel takes: one edge block
    per window, no spill lanes, the pooling layout, no intermediates. Every
    other ELL batch raises ``NotImplementedError`` naming the kernel-table
    rows it needs (``layer_row``, the model's per-layer ELL kernel; row 24
    for the spill tail)."""
    _, k = ell_geometry(batch)
    spill = batch["senders"].shape[0] - batch["loc_ulocal"].shape[0]
    why, rows = None, f"row {layer_row}"
    if k != 1:
        why = f"k={k} edge blocks per window"
    elif spill:
        why, rows = f"{spill} spill lanes", f"rows {layer_row} and 24"
    elif "pool_gl" not in batch:
        why = f"more than POOL_GMAX={POOL_GMAX} graphs in a window"
    elif return_intermediates:
        why = "return_intermediates (the whole-model kernel keeps h on chip)"
    if why:
        raise NotImplementedError(
            f"ELL batch with {why}: runs the per-layer ELL path (kernel table "
            f"{rows}), not ported yet (ROADMAP queue 2 B)"
        )


def ell_meta(batch: dict) -> torch.Tensor:
    """[P, 5] int32 per ELL lane: (u_local, v_local, the three bond attrs
    with their vocabulary offsets), the lane operand of the whole-model ELL
    kernels."""
    p = batch["loc_ulocal"].shape[0]
    offs = torch.as_tensor(BOND_FEATURE_OFFSETS, device=batch["edge_attr"].device)
    return torch.cat([
        batch["loc_ulocal"][:, None].int(), batch["loc_vlocal"][:, None].int(),
        (batch["edge_attr"][:p] + offs).int(),
    ], dim=1)


# Batch keys of the layouts not ported yet (ROADMAP queue 2): the legacy
# dynamic-window layout (``loc_ulocal`` without ``loc_ell``), the edge-block
# and spill-block layouts, and the ELL layout for the models without ELL
# kernels.
UNPORTED_LAYOUT_KEYS = ("loc_ulocal", "loc_ell", "blk_vlocal", "spill_blk_vlocal")


def reject_unported_layouts(batch: dict, ell: bool = False) -> None:
    """Raise ``NotImplementedError`` on a batch in a layout the port does
    not run yet. ``ell=True`` (GIN, GCN) lets the ELL layout through."""
    ell = ell and "loc_ell" in batch
    for key in UNPORTED_LAYOUT_KEYS:
        if key in batch and not (ell and key in ("loc_ulocal", "loc_ell")):
            raise NotImplementedError(
                f"batch layout with {key!r} is not ported yet for this model "
                "(ROADMAP queue 2)"
            )


def batch_signature(batch: dict):
    """Static layout signature of a batch: the sorted (key, shape, dtype)
    tuple."""
    return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in batch.items()))


def as_batches_uniform(
    buckets, blocked=False, window: int | None = None, block: int | None = None,
) -> list:
    """as_batch over a bucket stream, with the slot depth and prefix caps
    reconciled to stream-wide maxima so that every bucket shares one
    layout signature. ELL buckets need nothing reconciled: the one
    stream-wide parameter the JAX package pins for them is the spill-tail
    length, and a bucket that spills raises here."""
    mk = lambda b, **kw: as_batch(b, blocked=blocked, window=window, block=block, **kw)
    batches = [mk(b) for b in buckets]
    if (
        blocked != "local_slots" or len(batches) < 2
        or len({batch_signature(b) for b in batches}) == 1
    ):
        return batches
    caps = [
        tuple(
            b[f"slot_pcap_{k}"].shape[-2] for k in range(b["slot_geom"].shape[-1])
        )
        for b in batches
    ]
    kw = dict(
        slots=max(b["slot_geom"].shape[-1] for b in batches),
        # Missing deeper slots contribute the 64-row floor.
        prefix_caps=tuple(
            max(c) for c in itertools.zip_longest(*caps, fillvalue=64)
        ),
    )
    return [mk(b, **kw) for b in buckets]


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device``. Marker arrays keep their shapes,
    which carry static geometry."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
    }


# ---------------------------------------------------------------------------
# Device half: plain torch around the kernels.
# ---------------------------------------------------------------------------


def acc_dtype(prec: Precision) -> torch.dtype:
    """Accumulation dtype: f32 for f32/bf16 compute, f64 for f64."""
    return torch.float64 if prec.compute_dtype == torch.float64 else torch.float32


def num_nodes_static(batch: dict) -> int:
    """Padded node-axis length (N+1)."""
    return batch["node_feat"].shape[0]


def num_graphs_static(batch: dict) -> int:
    return batch["n_node"].shape[0]


def _embed_sum(table: torch.Tensor, rows: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Σ_f table[rows[:, f]], summed in the accumulation dtype."""
    return table.to(acc_dtype(prec))[rows].sum(dim=1).to(prec.compute_dtype)


def atom_embed(table: torch.Tensor, node_feat: torch.Tensor, prec: Precision) -> torch.Tensor:
    """h0[v] = Σ_f AtomTable[offset_f + feat_f[v]] (GIN/src/load_inputs.cc:174-220)."""
    from ..core.features import ATOM_FEATURE_OFFSETS

    offs = torch.as_tensor(ATOM_FEATURE_OFFSETS, device=node_feat.device)
    return _embed_sum(table, node_feat.long() + offs, prec)


def bond_embed(table_l: torch.Tensor, edge_attr: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ee[e] = Σ_f BondTable_l[offset_f + attr_f[e]] (GIN/src/message_passing.cc:136-146)."""
    offs = torch.as_tensor(BOND_FEATURE_OFFSETS, device=edge_attr.device)
    return _embed_sum(table_l, edge_attr.long() + offs, prec)


def gather_sources(h: torch.Tensor, batch: dict) -> torch.Tensor:
    """h_u per edge."""
    return h[batch["senders"].long()]


def edge_segment_sum(vals: torch.Tensor, batch: dict) -> torch.Tensor:
    """Per-receiver message sum over the plain edge list."""
    return segment_sum(vals, batch["receivers"], num_nodes_static(batch))


def out_degree(batch: dict) -> torch.Tensor:
    """Edges-with-source-u count per node (degree_table[u]++,
    GIN/src/load_inputs.cc:130), pad node included. Slot batches carry it
    precomputed on the host (``_attach_degrees``)."""
    if "out_deg" in batch:
        return batch["out_deg"]
    ones = torch.ones_like(batch["senders"], dtype=torch.int32)
    return segment_sum(ones, batch["senders"], num_nodes_static(batch))


def in_degree(batch: dict) -> torch.Tensor:
    """Edges-with-dest-v count per node, pad node included."""
    if "in_deg" in batch:
        return batch["in_deg"]
    ones = torch.ones_like(batch["receivers"], dtype=torch.int32)
    return segment_sum(ones, batch["receivers"], num_nodes_static(batch))


def mean_pool(h: torch.Tensor, batch: dict) -> torch.Tensor:
    """Per-graph mean over nodes (GIN/src/finalize.cc:38-115): the segment
    sum divided by the graph's node count. Pad graph rows are garbage."""
    total = segment_sum(h, batch["node_graph"], num_graphs_static(batch))
    count = batch["n_node"].clamp(min=1).to(h.dtype)
    return total / count[:, None]


def pool_finish(
    partials: torch.Tensor, batch: dict, b: Optional[torch.Tensor],
    prec: Precision,
) -> torch.Tensor:
    """[NW·GMAX, k] in-kernel pool sums → [G, k] per-graph means (+b)."""
    sums = partials[batch["pool_row"].long()]
    count = batch["n_node"].clamp(min=1).to(partials.dtype)
    out = (sums / count[:, None]).to(prec.compute_dtype)
    if b is not None:
        out = out + b
    return out


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """Row-major matvec y = x @ w.T + b (GIN/src/linear.cc:5-161): the
    product in the accumulation dtype, rounded to the compute dtype, then
    the bias added in the compute dtype."""
    acc = acc_dtype(prec)
    y = (x.to(acc) @ w.to(acc).T).to(prec.compute_dtype)
    if b is not None:
        y = y + b
    return y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)
