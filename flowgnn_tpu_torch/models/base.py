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
the degree-sorted dest-major slot layout of the slot kernels, with the
blocked spill tail of the edges that leave it (``_attach_spill_blocks``),
``blocked="local_ell"`` the ELL layout of the ELL kernels, with the same
blocked spill tail appended after its lanes, ``blocked=True`` the edge-block
layout (the edge axis in block order, ``blk_vlocal`` / ``blk_window``) whose
message sums run through ``edge_segment_sum``'s windowed scatter, and
``blocked="local"`` the legacy dynamic-window local layout (``loc_ulocal`` /
``loc_vlocal`` / ``loc_window`` and an un-blocked spill tail).
Their arrays hold the same values as ``flowgnn_tpu.models.base.as_batch``
builds, stored as int32 where the JAX package stores bfloat16 (the TPU's
one-hot ``spill_gblk_onehot`` is left out); static geometry rides in the
shapes of the marker arrays ``slot_pcap_k``, ``slot_geom``,
``spill_blk_geom``, ``spill_blk_compact`` (the port's own) and ``loc_ell``.
"""

from __future__ import annotations

import functools
import itertools
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.features import ATOM_FEATURE_OFFSETS, BOND_FEATURE_OFFSETS
from ..core.graphs import PackedGraphs
from ..core.numerics import Precision
from ..ops.segment import segment_sum
from ..ops.spmm import segment_sum_blocked, windowed_segment_sum

# Window and ELL block per model. The slot megakernels read only the window;
# the block is the ELL lanes per window and feeds only the ELL layout. The
# windows are the port's own: W=128 for every model, where the JAX package's
# v5e table puts GIN-VN at W=256 and GAT at W=384 (figures of that chip's
# 128-lane tiles). Every kernel of the port takes a window of 128 to 1024
# rows (the whole-model and one-layer kernels as a thread-block cluster of
# W/128 blocks, whose shared memory holds the window's state), so the window
# is a choice of speed, not of fit. On an H100 80GB HBM3 at 700 W, molhiv,
# bf16 (PERF.md §6): in four pairs GIN-VN at W=256 ran 7.5% faster than at
# W=128 end to end and by replay; GAT at W=384 16% faster eager but 60%
# slower by replay (its W=128 pass is host-bound); ``cli tune`` read GAT at
# W=256 32% faster than W=128 in one eager run. Too few pairs to move a
# default: the benchmark that sets the port's cells decides the windows, in
# ten pairs or more a choice. DGN and GAT take the block
# the JAX bench derives at --ell-window 128 (bench.py:147-158 over its
# ELL_GEOMETRY_DEFAULTS): 512. GAT needs it: its self loops add up to 128
# lanes to a window whose fullest holds 286 on molhiv, which would push a
# block of 384 to two blocks per window.
GEOMETRY_DEFAULTS: dict[str, tuple[int, int]] = {
    "gin": (128, 384),
    "gin-vn": (128, 384),
    "gcn": (128, 384),
    "gat": (128, 512),
    "pna": (128, 384),
    "dgn": (128, 512),
}
# The ELL layout's window and block when ``as_batch`` is given none: the JAX
# package's PALLAS_ELL_WINDOW / PALLAS_ELL_BLOCK.
ELL_DEFAULT_GEOMETRY = (512, 1536)
MAX_SLOTS = 8  # deepest slot axis; deeper in-degrees spill
POOL_GMAX = 64  # graph slots per window in the in-kernel pooling layout
PALLAS_WINDOW = 128  # node window of the edge-block and legacy local layouts
PALLAS_BLOCK = 128  # lanes per block of those layouts and of the spill tail's blocked layout
LOCAL_SPILL_CAPACITY = 8192  # lanes of the legacy local layout's spill tail, fixed
SPILL_SCATTER_WINDOW = 512  # receiver window of the spill tail's scatter


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


def _attach_spill_blocks(
    batch: dict, sp_recv: np.ndarray, n: int, sp_send: Optional[np.ndarray] = None,
):
    """Pair-blocked layout of the spill tail (``flowgnn_tpu.models.base.
    _attach_spill_blocks``). Real spill lanes are sorted by (receiver
    window, sender window, lane) over windows of SPILL_SCATTER_WINDOW rows
    and padded to PALLAS_BLOCK-lane blocks per pair, so one lane order serves
    the scatter (``spill_segment_sum``: blocks of one receiver window are
    consecutive, and only the T windows that receive spill lanes are
    computed) and the gather (each block reads one sender window).

    Attaches ``spill_blk_vlocal`` [NB·128] (each lane's receiver row in its
    window, sentinel 512 on pad lanes), ``spill_blk_window`` [NB] (each
    block's compact window 0..T−1, non-decreasing), ``spill_blk_winmap``
    [⌈n/512⌉] (each window's compact index, sentinel T), the
    ``spill_blk_geom`` marker whose shape carries the window, the
    ``spill_blk_compact`` marker whose shape carries T (the port's own: the
    JAX package reads T off ``spill_blk_window`` on the host, which on the
    card would wait for the device), and, when ``sp_send`` is given and
    every sender lies in a full window, ``spill_gblk_src`` [NB] (each
    block's sender window). The JAX package's ``spill_gblk_onehot`` is left
    out: it feeds the TPU's MXU a one-hot, and ``spill_gather`` here gathers
    by index. Returns (perm, valid), the caller's re-ordering of the spill
    lanes."""
    w = SPILL_SCATTER_WINDOW
    nw = -(-n // w)
    sp_recv = np.asarray(sp_recv)
    real = np.nonzero(sp_recv < n - 1)[0]
    rw = sp_recv[real] // w
    srcw = (
        np.asarray(sp_send)[real] // w if sp_send is not None
        else np.zeros(real.shape[0], np.int64)
    )
    order = np.lexsort((real, srcw, rw))
    real, rw, srcw = real[order], rw[order], srcw[order]
    blocks: list = []
    i = 0
    while i < real.shape[0]:
        j = i
        while j < real.shape[0] and rw[j] == rw[i] and srcw[j] == srcw[i]:
            j += 1
        seg = real[i:j]
        for b in range(-(-seg.shape[0] // PALLAS_BLOCK)):
            blocks.append(
                (int(rw[i]), int(srcw[i]), seg[b * PALLAS_BLOCK : (b + 1) * PALLAS_BLOCK])
            )
        i = j
    if not blocks:
        blocks = [(0, 0, np.zeros(0, np.int64))]
    nb = len(blocks)
    perm = np.zeros(nb * PALLAS_BLOCK, np.int64)
    valid = np.zeros(nb * PALLAS_BLOCK, bool)
    for bi, (_, _, lanes) in enumerate(blocks):
        perm[bi * PALLAS_BLOCK : bi * PALLAS_BLOCK + lanes.shape[0]] = lanes
        valid[bi * PALLAS_BLOCK : bi * PALLAS_BLOCK + lanes.shape[0]] = True
    vloc = np.full(nb * PALLAS_BLOCK, w, np.int32)
    vloc[valid] = sp_recv[perm[valid]] % w
    recw = np.array([b[0] for b in blocks], np.int64)
    uniq, t_ids = np.unique(recw, return_inverse=True)
    winmap = np.full(nw, uniq.shape[0], np.int32)  # sentinel = T
    winmap[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    batch["spill_blk_vlocal"] = vloc
    batch["spill_blk_window"] = t_ids.astype(np.int32)
    batch["spill_blk_winmap"] = winmap
    batch["spill_blk_geom"] = np.zeros((w,), np.int8)  # window in the shape
    batch["spill_blk_compact"] = np.zeros((uniq.shape[0],), np.int8)  # T in the shape
    if sp_send is not None:
        src_ids = np.array([b[1] for b in blocks], np.int32)
        # The JAX gather slices h to its full windows: a sender in the
        # partial trailing window leaves the gather-side layout out.
        if int(src_ids.max(initial=0)) < n // w:
            batch["spill_gblk_src"] = src_ids
    return perm, valid


def as_batch(
    packed: PackedGraphs, blocked=False, window: int | None = None,
    block: int | None = None, *, slots: int | None = None, prefix_caps=None,
    spill_capacity: int | None = None,
) -> dict:
    """PackedGraphs → dict of numpy arrays.

    ``blocked=False`` gives the plain edge-list batch. ``blocked=
    "local_slots"`` (needs window-aligned packing) re-orders each window's
    rows by local in-degree and attaches the dest-major slot layout. Edges
    that cross a window, or exceed a row's slot depth, go to the spill tail:
    ``slot_spill`` holds their edge indices in the blocked order of
    ``_attach_spill_blocks`` and ``slot_spill_mask`` marks the real lanes.
    A bucket with no spill tail also gets the prefix layout of the
    whole-model kernels: ``slot_meta`` [NW·Σc, 4] holds, per prefix lane,
    (src − W/2, the three bond attrs with their vocabulary offsets); empty
    lanes carry src = W − W/2 and attrs −1. ``slots`` / ``prefix_caps`` /
    ``spill_capacity`` pin the slot depth, the per-slot caps and the spill
    tail's lanes so that the buckets of a stream share one layout where they
    can (``as_batches_uniform``). ``blocked="local_ell"`` (window-aligned
    packing too) keeps the node order and attaches the ELL layout of
    ``window`` rows and ``block`` lanes per edge block, with its spill tail
    (see ``_attach_ell_layout``); ``spill_capacity`` pins that tail's
    length before blocking. ``blocked=True`` replaces the edge arrays by
    their edge-block order (``core.blocking.build_edge_blocks`` at
    PALLAS_WINDOW / PALLAS_BLOCK; any packing) and attaches ``blk_vlocal``
    and ``blk_window``, no degrees and no pool layout. ``blocked="local"``
    (window-aligned packing at PALLAS_WINDOW) is the legacy dynamic-window
    local layout (``_attach_local_layout``); it ignores ``window``,
    ``block`` and ``spill_capacity``.

    Without a window, the ELL layout takes the JAX package's (512, 1536)
    (``ELL_DEFAULT_GEOMETRY``), and the slot layout W=128, where the JAX
    package takes 512. Every whole-model slot kernel (rows 1-5:
    ``gin_local_model_slots``, ``gcn_local_model_slots``,
    ``pna_local_model``, ``dgn_local_model``, ``gat_local_model_slots``)
    takes windows of 128 up to 1024 rows, one thread-block cluster of W/128
    blocks per window, each block holding 128 rows in its shared memory, so
    every model runs the slot layout at W=512 as the JAX bench does.
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
        gw, gb = ELL_DEFAULT_GEOMETRY
        _attach_ell_layout(batch, packed, window or gw, block or gb, spill_capacity)
        return batch
    if blocked == "local":
        _attach_local_layout(batch, packed)
        return batch
    if blocked != "local_slots":
        _attach_edge_blocks(batch, packed)
        return batch
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
        senders, receivers, n, window=w, slots=s_slots, spill_capacity=spill_capacity,
    )
    batch["slot_src"] = slot_src  # [NW·W, S]
    nw = slot_src.shape[0] // w
    slot3 = slot_src.reshape(nw, w, s_slots)
    batch["slot_stack"] = np.ascontiguousarray(slot3.transpose(0, 2, 1)).reshape(-1)
    if count == 0:
        _attach_prefix_layout(batch, slot3, slot_edge, w, prefix_caps)
    batch["slot_spill"] = spill
    batch["slot_spill_mask"] = np.arange(spill.shape[0]) < count
    if count:
        # The spill lanes in blocked order, masked lanes → edge 0, flagged
        # off (the models route them at the pad node).
        mask = batch["slot_spill_mask"]
        perm, valid = _attach_spill_blocks(
            batch, np.where(mask, receivers[spill], n - 1), n,
            sp_send=np.where(mask, senders[spill], n - 1),
        )
        batch["slot_spill"] = np.where(valid, spill[perm], 0).astype(spill.dtype)
        batch["slot_spill_mask"] = valid
    # Shape carries (window, slots) to the model.
    batch["slot_geom"] = np.zeros((w, s_slots), np.int32)
    _attach_pool_layout(batch, packed, w, batch["node_graph"])
    _attach_degrees(batch, n)
    return batch


def _attach_prefix_layout(batch: dict, slot3: np.ndarray, slot_edge: np.ndarray,
                          w: int, prefix_caps) -> None:
    """The prefix-compacted layout of a bucket with no spill tail: slot k's
    real lanes are rows [0, c_k) of each window (``slot_pstack``, the
    ``slot_pcap_k`` markers and ``slot_meta``). The static caps are the max
    occupancy over windows, rounded up to 64 rows (the JAX package's floor,
    kept for equal layouts)."""
    nw, _, s_slots = slot3.shape
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


def _edges_at(packed: PackedGraphs, idx: np.ndarray, ok: np.ndarray, pad: int):
    """``packed``'s (senders, receivers, edge_attr) at the edges ``idx``
    where ``ok``; elsewhere the pad node with attrs 0."""
    return (np.where(ok, packed.senders[idx], pad).astype(np.int32),
            np.where(ok, packed.receivers[idx], pad).astype(np.int32),
            np.where(ok[:, None], packed.edge_attr[idx], 0).astype(np.int32))


def _attach_ell_layout(batch: dict, packed: PackedGraphs, window: int, block: int,
                       spill_capacity: int | None = None) -> None:
    """The ELL layout of ``flowgnn_tpu.models.base.as_batch``: ``senders`` /
    ``receivers`` / ``edge_attr`` re-ordered into the P = NW·k·block lanes
    (pad lanes point at the pad node, attrs 0), then the spill tail
    appended after them: the edges that cross a window or overflow their
    window's lanes, in the blocked order of ``_attach_spill_blocks`` (pad
    lanes point at the pad node, attrs 0; a tail of pad lanes only, from a
    pinned ``spill_capacity``, stays unblocked). Also ``loc_ulocal`` /
    ``loc_vlocal``, the ELL lanes' in-window endpoints, the ``loc_ell``
    marker whose shape (window, k) carries the geometry, the pooling layout
    over the un-permuted ``node_graph``, and the degree tables over every
    lane."""
    from ..core.blocking import build_local_blocks_ell

    n = packed.node_capacity + 1
    pad = n - 1
    lb = build_local_blocks_ell(packed.senders, packed.receivers, n, window=window,
                                block=block, spill_capacity=spill_capacity)
    if lb.k_blocks > 1:
        warnings.warn(
            f"ELL grid k={lb.k_blocks} (the densest window exceeds block={lb.block}): "
            f"every window runs {lb.k_blocks} blocks of lanes; consider a block of at "
            f"least {lb.k_blocks * lb.block}",
            stacklevel=3,
        )
    s, r, a = _edges_at(packed, lb.edge_perm, lb.valid, pad)
    # Spill slots past the real ones hold edge 0: neutralise them.
    sp_s, sp_r, sp_a = _edges_at(packed, lb.spill, np.arange(lb.spill.shape[0]) < lb.spill_count,
                                 pad)
    if lb.spill_count:
        perm, valid = _attach_spill_blocks(batch, sp_r, n, sp_send=sp_s)
        sp_s = np.where(valid, sp_s[perm], pad)
        sp_r = np.where(valid, sp_r[perm], pad)
        sp_a = np.where(valid[:, None], sp_a[perm], 0)
    batch["senders"] = np.concatenate([s, sp_s])
    batch["receivers"] = np.concatenate([r, sp_r])
    batch["edge_attr"] = np.concatenate([a, sp_a])
    batch["loc_ulocal"] = lb.u_local
    batch["loc_vlocal"] = lb.v_local
    batch["loc_ell"] = np.zeros((lb.window, lb.k_blocks), np.int32)
    _attach_pool_layout(batch, packed, lb.window, packed.node_graph)
    _attach_degrees(batch, n)


def _attach_local_layout(batch: dict, packed: PackedGraphs) -> None:
    """The legacy dynamic-window local layout of ``flowgnn_tpu.models.base.
    as_batch(blocked="local")``: ``senders`` / ``receivers`` / ``edge_attr``
    re-ordered into the P = NB·128 lanes of ``core.blocking.
    build_local_blocks`` (pad lanes point at the pad node, attrs 0), then
    the un-blocked spill tail of LOCAL_SPILL_CAPACITY lanes: the edges that
    cross a window in edge order, the lanes past them neutralised to the pad
    node. Also ``loc_ulocal`` / ``loc_vlocal``, the lanes' in-window
    endpoints, ``loc_window``, each block's window, and the degree tables
    over every lane. More crossing edges than the tail holds raise
    ``ValueError``."""
    from ..core.blocking import build_local_blocks

    n = packed.node_capacity + 1
    pad = n - 1
    lb = build_local_blocks(packed.senders, packed.receivers, n, packed.edge_capacity,
                            window=PALLAS_WINDOW, block=PALLAS_BLOCK,
                            spill_capacity=LOCAL_SPILL_CAPACITY)
    s, r, a = _edges_at(packed, lb.edge_perm, lb.valid, pad)
    # Spill slots past the real ones hold edge 0: neutralise them.
    sp_s, sp_r, sp_a = _edges_at(packed, lb.spill, np.arange(lb.spill.shape[0]) < lb.spill_count,
                                 pad)
    batch["senders"] = np.concatenate([s, sp_s])
    batch["receivers"] = np.concatenate([r, sp_r])
    batch["edge_attr"] = np.concatenate([a, sp_a])
    batch["loc_ulocal"] = lb.u_local
    batch["loc_vlocal"] = lb.v_local
    batch["loc_window"] = lb.block_window
    _attach_degrees(batch, n)


def _attach_edge_blocks(batch: dict, packed: PackedGraphs) -> None:
    """The edge-block layout of ``flowgnn_tpu.models.base.as_batch(
    blocked=True)``: the edge arrays replaced by their block order (a
    re-ordering and padding of the edge axis, pad lanes at the pad node),
    ``blk_vlocal`` each lane's receiver row in its window (sentinel
    PALLAS_WINDOW on pads) and ``blk_window`` each block's window."""
    from ..core.blocking import apply_blocking, build_edge_blocks

    n = packed.node_capacity + 1  # with the pad node's row
    blocks = build_edge_blocks(packed.receivers, n, packed.edge_capacity,
                               window=PALLAS_WINDOW, block=PALLAS_BLOCK)
    batch["senders"], batch["receivers"], batch["edge_attr"] = apply_blocking(
        blocks, packed.senders, packed.receivers, packed.edge_attr, n - 1)
    batch["blk_vlocal"] = blocks.v_local
    batch["blk_window"] = blocks.block_window


def ell_geometry(batch: dict) -> tuple[int, int]:
    """(window, k_blocks) of an ELL batch, from the ``loc_ell`` marker's
    trailing two dims."""
    m = batch["loc_ell"]
    return int(m.shape[-2]), int(m.shape[-1])


def ell_spill_lanes(batch: dict) -> int:
    """The lanes of an ELL batch's spill tail (after its P ELL lanes)."""
    return batch["senders"].shape[0] - batch["loc_ulocal"].shape[0]


def ell_megakernel(batch: dict, return_intermediates: bool) -> bool:
    """Whether an ELL batch runs its model's whole-model ELL kernel: one
    edge block per window, no spill lanes, the pooling layout and no
    intermediates (the JAX package's dispatch, ``flowgnn_tpu/models/
    gin.py:154-162`` and ``gcn.py:118-132``, which also needs ``wps`` = 1;
    the port has no ``wps``). Every other ELL batch runs the per-layer ELL
    path."""
    _, k = ell_geometry(batch)
    return (k == 1 and not ell_spill_lanes(batch) and "pool_gl" in batch
            and not return_intermediates)


def ell_meta(batch: dict) -> torch.Tensor:
    """[P, 5] int32 per ELL lane: (u_local, v_local, the three bond attrs
    with their vocabulary offsets), the lane operand of the ELL kernels."""
    p = batch["loc_ulocal"].shape[0]
    return torch.cat([
        batch["loc_ulocal"][:, None].int(), batch["loc_vlocal"][:, None].int(),
        (batch["edge_attr"][:p] + feature_offsets("bond", batch["edge_attr"].device)).int(),
    ], dim=1)


def batch_signature(batch: dict):
    """Static layout signature of a batch: the sorted (key, shape, dtype)
    tuple."""
    return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in batch.items()))


def as_batches_uniform(
    buckets, blocked=False, window: int | None = None, block: int | None = None,
) -> list:
    """as_batch over a bucket stream, with the slot depth, and the prefix
    caps when no bucket spills or the spill-tail capacity when every bucket
    does, reconciled to stream-wide maxima, so that the buckets share one
    layout signature where they can (the blocked spill layout depends on
    each bucket's content). ELL buckets reconcile the spill tail's
    capacity, when every bucket spills. The edge-block and legacy local
    layouts have nothing to reconcile: their shapes follow the packing's
    capacities alone (the JAX package re-runs ``as_batch`` on legacy local
    buckets with the tail's fixed capacity pinned, which that layout
    ignores: the same batches)."""
    mk = lambda b, **kw: as_batch(b, blocked=blocked, window=window, block=block, **kw)
    batches = [mk(b) for b in buckets]
    if len(batches) < 2 or len({batch_signature(b) for b in batches}) == 1:
        return batches
    kw = {}
    if blocked == "local_slots":
        kw["slots"] = max(b["slot_geom"].shape[-1] for b in batches)
        if all("slot_pcap_0" in b for b in batches):
            caps = [
                tuple(b[f"slot_pcap_{k}"].shape[-2] for k in range(b["slot_geom"].shape[-1]))
                for b in batches
            ]
            # Missing deeper slots contribute the 64-row floor.
            kw["prefix_caps"] = tuple(max(c) for c in itertools.zip_longest(*caps, fillvalue=64))
        elif all(b["slot_spill_mask"].any() for b in batches):
            kw["spill_capacity"] = max(b["slot_spill"].shape[-1] for b in batches)
    elif blocked == "local_ell":
        tails = [ell_spill_lanes(b) for b in batches]
        if min(tails) > 0:
            kw["spill_capacity"] = max(tails)
    if not kw:
        return batches
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


@functools.cache
def feature_offsets(kind: str, device: torch.device) -> torch.Tensor:
    """The atom (``kind`` "atom") or bond ("bond") features' vocabulary
    offsets on ``device``, copied there once: a forward then copies nothing
    from the host, so a CUDA graph can capture it (``bench.timing``)."""
    return torch.as_tensor({"atom": ATOM_FEATURE_OFFSETS, "bond": BOND_FEATURE_OFFSETS}[kind],
                           device=device)


def atom_embed(table: torch.Tensor, node_feat: torch.Tensor, prec: Precision) -> torch.Tensor:
    """h0[v] = Σ_f AtomTable[offset_f + feat_f[v]] (GIN/src/load_inputs.cc:174-220)."""
    rows = node_feat.long() + feature_offsets("atom", node_feat.device)
    return prec.q(_embed_sum(table, rows, prec))


def bond_rows(edge_attr: torch.Tensor) -> torch.Tensor:
    """[E, 3] bond-table rows: the attrs with their vocabulary offsets."""
    return edge_attr.long() + feature_offsets("bond", edge_attr.device)


def bond_embed(table_l: torch.Tensor, edge_attr: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ee[e] = Σ_f BondTable_l[offset_f + attr_f[e]] (GIN/src/message_passing.cc:136-146)."""
    return prec.q(_embed_sum(table_l, bond_rows(edge_attr), prec))


def ell_spill(batch: dict) -> Optional[tuple]:
    """An ELL batch's spill tail as the per-layer ELL paths use it,
    computed once per forward: (each lane's sender, its receiver, its
    ``bond_rows``), or None without a tail."""
    if not ell_spill_lanes(batch):
        return None
    p = batch["loc_ulocal"].shape[0]
    return (batch["senders"][p:].long(), batch["receivers"][p:].long(),
            bond_rows(batch["edge_attr"][p:]))


def spill_messages(h: torch.Tensor, table_l: torch.Tensor, spill: tuple,
                   prec: Precision) -> torch.Tensor:
    """relu(h_u + ee) per lane of an ELL batch's spill tail (``spill`` as
    ``ell_spill`` gives it)."""
    return relu(spill_gather(h, spill[0]) + _embed_sum(table_l, spill[2], prec))


def halo_mode(batch: dict, axis) -> bool:
    """Whether ``batch`` is one rank's shard of the halo layout
    (``parallel.halo``) run over the mesh axis ``axis``: node arrays are the
    rank's rows, receivers are local (trash row S), senders index the
    extended node space."""
    return axis is not None and "halo_send_idx" in batch


def halo_exchange(h: torch.Tensor, batch: dict, axis, wait: bool = True):
    """Ship this rank's boundary rows to every peer and return the extended
    node array [S + k·H, D] = [local rows ‖ halo rows] that the re-indexed
    senders index: one all-to-all of the [k, H, D] rows over ``axis``. With
    ``wait=False`` the exchange is issued and a callable returned that waits
    for it and gives the extended array, so that work which does not read
    the halo rows can run meanwhile."""
    send_idx = batch["halo_send_idx"]  # [k, H]: this rank's rows per peer
    k, cap = send_idx.shape
    send = h[send_idx.reshape(-1).long()].reshape(k, cap, -1)
    recv = axis.all_to_all(send, wait=False)

    def finish() -> torch.Tensor:
        return torch.cat([h, recv().reshape(k * cap, h.shape[1])])

    return finish() if wait else finish


def sender_rows(h: torch.Tensor, batch: dict, axis=None, wait: bool = True):
    """The rows that ``batch``'s senders index: on a halo shard ``h``
    extended by the exchanged boundary rows (``halo_exchange``; with
    ``wait=False`` a callable that waits for the exchange, issued now), else
    ``h`` itself (with ``wait=False`` a callable that gives it)."""
    if halo_mode(batch, axis):
        return halo_exchange(h, batch, axis, wait)
    return h if wait else (lambda: h)


def receiver_rows(x: torch.Tensor, batch: dict, axis=None) -> torch.Tensor:
    """The rows that ``batch``'s receivers index: on a halo shard ``x`` [n,
    ...] with one zero row appended, the trash row S that pad lanes name as
    their receiver (the JAX package reads past the array there, which its
    gather fills), else ``x`` itself."""
    if halo_mode(batch, axis):
        return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return x


def dead_row(batch: dict, axis=None) -> int:
    """The row a pad lane names as its receiver: the trash row S of a halo
    shard, the pad node otherwise."""
    n = num_nodes_static(batch)
    return n if halo_mode(batch, axis) else n - 1


def receiver_space(batch: dict, axis=None) -> tuple:
    """(rows, reduction axis) of a per-receiver reduction whose first n rows
    are kept: on a halo shard n + 1 rows, the last the trash row, and no
    collective (the exchange happened on the gather side); else n rows,
    completed over ``axis`` on the path whose edges are split over it
    (``parallel.inference.sharded_forward``)."""
    n = num_nodes_static(batch)
    return (n + 1, None) if halo_mode(batch, axis) else (n, axis)


def gather_sources(h: torch.Tensor, batch: dict, axis=None) -> torch.Tensor:
    """h_u per edge (``sender_rows``: on a halo shard from the extended node
    space)."""
    return sender_rows(h, batch, axis)[batch["senders"].long()]


def edge_segment_sum(vals: torch.Tensor, batch: dict, axis=None) -> torch.Tensor:
    """Per-receiver message sum [n, D'] of the per-edge values [E, D']: the
    windowed scatter (kernel table row 24) when the batch carries the
    edge-block layout, whose edge axis is already in block order; a plain
    segment sum over ``receiver_space`` otherwise."""
    n = num_nodes_static(batch)
    if axis is None and "blk_vlocal" in batch:
        return segment_sum_blocked(vals, batch["blk_vlocal"], batch["blk_window"], n,
                                   PALLAS_WINDOW)
    rows, red = receiver_space(batch, axis)
    return segment_sum(vals, batch["receivers"], rows, red)[:n]


def blocked_segment_operands(vals: torch.Tensor, batch: dict) -> dict:
    """The operands ``edge_segment_sum`` hands ``ops.spmm.
    windowed_segment_sum`` (through ``segment_sum_blocked``) for the edge
    values [P, D'] of an edge-block batch: every window of PALLAS_WINDOW
    rows."""
    return dict(
        values=vals, v_local=batch["blk_vlocal"][:, None], block_window=batch["blk_window"],
        window=PALLAS_WINDOW, num_windows=-(-num_nodes_static(batch) // PALLAS_WINDOW),
    )


def spill_lanes(batch: dict, axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sender, receiver) of each lane of a slot batch's spill tail, both
    ``dead_row`` on masked lanes, whose results nothing reads (on a halo
    shard the sender then reads an extended row)."""
    pad = dead_row(batch, axis)
    sp = batch["slot_spill"].long()
    mask = batch["slot_spill_mask"]
    return (
        torch.where(mask, batch["senders"].long()[sp], pad),
        torch.where(mask, batch["receivers"].long()[sp], pad),
    )


def spill_gather(h: torch.Tensor, u_tail: torch.Tensor) -> torch.Tensor:
    """h of each spill lane's sender, by index (the JAX package's one-hot
    gather over ``spill_gblk_src`` is the same exact gather). A pad lane
    reads the pad node's row; its receiver is the sentinel, so no sum
    takes it."""
    return h[u_tail]


def spill_segment_operands(vals: torch.Tensor, batch: dict) -> dict:
    """The operands ``spill_segment_sum`` hands ``ops.spmm.
    windowed_segment_sum`` for spill lane values [P, D'] in blocked order:
    the T compact windows that receive spill lanes (``spill_blk_compact``'s
    length)."""
    return dict(
        values=vals, v_local=batch["spill_blk_vlocal"][:, None],
        block_window=batch["spill_blk_window"],
        window=int(batch["spill_blk_geom"].shape[0]),
        num_windows=int(batch["spill_blk_compact"].shape[0]),
    )


def spill_segment_sum(vals: torch.Tensor, batch: dict, receivers: torch.Tensor) -> torch.Tensor:
    """Per-node sum [n, D'] of the spill lane values [P, D'] of a slot or an
    ELL batch, ``receivers`` each lane's receiver. Where the tail is blocked:
    the windowed segment sum (kernel table row 24) over the compact windows
    of the blocked layout, each window then taken to its rows by
    ``spill_blk_winmap`` (windows with no spill lane read a zero window).
    Else a plain sum by receiver over n + 1 rows, the last a halo shard's
    trash row: a halo shard's tail has no blocked layout (the JAX package
    sums it into the trash row), nor has a tail of pad lanes only (a pinned
    ``spill_capacity`` on a bucket that spills nothing; the JAX package's
    ``spill_segment_sum`` falls back to its XLA segment sum there)."""
    n = num_nodes_static(batch)
    if "spill_blk_vlocal" not in batch:
        return segment_sum(vals, receivers, n + 1)[:n]
    ops = spill_segment_operands(vals, batch)
    w, t, d = ops["window"], ops["num_windows"], vals.shape[1]
    compact = windowed_segment_sum(**ops).reshape(t, w, d)
    out3 = torch.cat([compact, compact.new_zeros(1, w, d)])
    return out3[batch["spill_blk_winmap"].long()].reshape(-1, d)[:n]


def ell_spill_segment_sum(vals: torch.Tensor, batch: dict) -> torch.Tensor:
    """Per-node sum [n, D'] of the values [S, D'] of an ELL batch's spill
    lanes (``spill_segment_sum``)."""
    return spill_segment_sum(vals, batch, batch["receivers"][batch["loc_ulocal"].shape[0]:])


def out_degree(batch: dict, axis=None) -> torch.Tensor:
    """Edges-with-source-u count per node (degree_table[u]++,
    GIN/src/load_inputs.cc:130), pad node included. Slot, ELL and halo
    batches carry it precomputed on the host (``_attach_degrees``,
    ``parallel.halo``); otherwise it is counted, and completed over
    ``axis`` when the edges are split over it."""
    if "out_deg" in batch:
        return batch["out_deg"]
    ones = torch.ones_like(batch["senders"], dtype=torch.int32)
    return segment_sum(ones, batch["senders"], num_nodes_static(batch), axis)


def in_degree(batch: dict, axis=None) -> torch.Tensor:
    """Edges-with-dest-v count per node, pad node included (as
    ``out_degree``)."""
    if "in_deg" in batch:
        return batch["in_deg"]
    ones = torch.ones_like(batch["receivers"], dtype=torch.int32)
    return segment_sum(ones, batch["receivers"], num_nodes_static(batch), axis)


def mean_pool(h: torch.Tensor, batch: dict, prec: Precision, axis=None) -> torch.Tensor:
    """Per-graph mean over nodes (GIN/src/finalize.cc:38-115): the segment
    sum divided by the graph's node count. Pad graph rows are garbage. On a
    halo shard each rank holds some of the nodes: the [G+1, D] graph sums
    are completed by one all-reduce over ``axis`` (``graph_axis``)."""
    total = segment_sum(h, batch["node_graph"], num_graphs_static(batch),
                        graph_axis(batch, axis))
    count = batch["n_node"].clamp(min=1).to(h.dtype)
    return prec.q(total / count[:, None])


def graph_axis(batch: dict, axis):
    """The axis over which per-graph sums of node rows are completed:
    ``axis`` on a halo shard, whose ranks hold some of the nodes; None
    otherwise (on the replicated-node path every rank holds them all)."""
    return axis if halo_mode(batch, axis) else None


def pool_gather(partials: torch.Tensor, axis) -> torch.Tensor:
    """The per-shard in-kernel pool partials [NW_shard·GMAX, T] completed
    across the edge axis: ranks own contiguous ranges of windows
    (``parallel.halo``), so one tiled all-gather gives the global [NW·GMAX,
    T] table that the replicated ``pool_row`` indexes. No-op without an
    axis."""
    return partials if axis is None else axis.all_gather(partials)


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
    return prec.q(out)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """Row-major matvec y = x @ w.T + b (GIN/src/linear.cc:5-161): the
    product in the accumulation dtype, rounded to the compute dtype, then
    the bias added in the compute dtype, then quantized (``prec.q``). Both
    operands are cast to the accumulation dtype first, as the JAX package's
    ``jnp.dot`` promotes the f32 activations of the fixed mode against f64
    or bf16 weights."""
    acc = acc_dtype(prec)
    y = (x.to(acc) @ w.to(acc).T).to(prec.compute_dtype)
    if b is not None:
        y = y + b
    return prec.q(y)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)
