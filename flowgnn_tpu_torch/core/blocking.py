"""Edge-block and graph-local layouts, built in numpy.

Copies of ``flowgnn_tpu.core.blocking``: the edge-block layout of
``--layout blocked`` (``EdgeBlocks``, ``blocks_capacity``,
``build_edge_blocks``, ``apply_blocking`` and its numpy oracle
``segment_sum_blocked_reference``), the legacy dynamic-window local layout
(``build_local_blocks``), the ELL layout (``build_local_blocks_ell``) and
the slot layout (``build_local_slots``). ``build_local_blocks_ell`` is the
JAX package's numpy loop, which is also the oracle of its native packer
(``runtime/packer.cc``, not ported): the same lanes.

The edge-block layout: edges stably sorted by receiver, receivers cut into
node windows of ``window`` rows, each window's edge list padded to whole
blocks of ``block`` lanes (pad lanes carry the in-window sentinel
``window``), at least one block per window, and a window id per block. Every
window wastes at most ``block − 1`` lanes, so ``blocks_capacity`` =
⌈edge_capacity / block⌉ + windows always suffices and is static per
(capacity, window, block); the blocks left over are pure padding, parked on
the last window so the window ids stay non-decreasing.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EdgeBlocks:
    """Static-shape edge-block layout (arrays sized num_blocks·block)."""

    perm: np.ndarray  # [P] int32 index into the original edge axis
    valid: np.ndarray  # [P] bool, False on pad lanes
    v_local: np.ndarray  # [P] int32 receiver − window base; ``window`` on pads
    block_window: np.ndarray  # [num_blocks] int32 window id per block
    window: int
    block: int

    @property
    def num_blocks(self) -> int:
        return int(self.block_window.shape[0])


def blocks_capacity(edge_capacity: int, num_nodes: int, window: int, block: int) -> int:
    num_windows = -(-num_nodes // window)
    return -(-edge_capacity // block) + num_windows


def _pack_window_blocks(
    edges: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_capacity: int,
    window: int,
    block: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The block fill both dynamic-window layouts share: ``edges`` (indices
    into the edge axis) stably sorted by receiver, each window's run padded
    to whole blocks, at least one block per window. Returns (perm [P] int32
    edge index per lane, 0 on pads; valid [P] bool; block_window [NB] int32,
    the blocks left over parked on the last window)."""
    num_windows = -(-num_nodes // window)
    nblocks = blocks_capacity(edge_capacity, num_nodes, window, block)
    perm = np.zeros(nblocks * block, np.int32)
    valid = np.zeros(nblocks * block, np.bool_)
    block_window = np.full(nblocks, num_windows - 1, np.int32)

    order = edges[np.argsort(receivers[edges], kind="stable")]
    wids = receivers[order] // window

    out_lane = out_block = i = 0
    for w in range(num_windows):
        j = i
        while j < len(order) and wids[j] == w:
            j += 1
        for bi in range(max(1, -(-(j - i) // block))):
            block_window[out_block] = w
            lo, hi = i + bi * block, min(i + (bi + 1) * block, j)
            k = hi - lo
            if k > 0:
                perm[out_lane : out_lane + k] = order[lo:hi]
                valid[out_lane : out_lane + k] = True
            out_lane += block
            out_block += 1
        i = j
    return perm, valid, block_window


def _in_window(nodes, perm, valid, block_window, window: int, block: int) -> np.ndarray:
    """Each lane's ``nodes[perm]`` relative to its block's window base;
    the sentinel ``window`` on pad lanes."""
    base = np.repeat(block_window, block) * window
    return np.where(valid, nodes[perm] - base, window).astype(np.int32)


def build_edge_blocks(
    receivers: np.ndarray,
    num_nodes: int,
    edge_capacity: int,
    window: int = 128,
    block: int = 128,
) -> EdgeBlocks:
    """The edge-block layout of one packed bucket. ``receivers`` is the full
    padded edge array; ``num_nodes`` counts the rows including the trailing
    pad node, and edges into the pad node (row num_nodes − 1) are dropped:
    its message is never read."""
    receivers = np.asarray(receivers)
    real = np.nonzero(receivers < num_nodes - 1)[0]
    perm, valid, block_window = _pack_window_blocks(
        real, receivers, num_nodes, edge_capacity, window, block)
    v_local = _in_window(receivers, perm, valid, block_window, window, block)
    return EdgeBlocks(perm, valid, v_local, block_window, window, block)


def apply_blocking(
    blocks: EdgeBlocks,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_attr: np.ndarray,
    pad_node: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The edge arrays permuted into block order at pack time, pad lanes
    pointing at the pad node (attrs 0). Models then run on the blocked order,
    a re-ordering of the edge axis, and the scatter kernel needs no run-time
    permutation or masking: pad lanes carry the in-window sentinel."""
    s = np.full(blocks.perm.shape[0], pad_node, np.int32)
    r = np.full(blocks.perm.shape[0], pad_node, np.int32)
    a = np.zeros((blocks.perm.shape[0], edge_attr.shape[1]), np.int32)
    val = blocks.valid
    s[val] = senders[blocks.perm[val]]
    r[val] = receivers[blocks.perm[val]]
    a[val] = edge_attr[blocks.perm[val]]
    return s, r, a


def segment_sum_blocked_reference(
    edge_values: np.ndarray, blocks: EdgeBlocks, num_nodes: int
) -> np.ndarray:
    """NumPy oracle of the blocked windowed segment sum: ``edge_values`` in
    the original edge order → [num_nodes, ...] float32."""
    w, b = blocks.window, blocks.block
    num_windows = -(-num_nodes // w)
    out = np.zeros((num_windows * w,) + edge_values.shape[1:], np.float32)
    vals = edge_values[blocks.perm] * blocks.valid[:, None]
    for blk in range(blocks.num_blocks):
        base = int(blocks.block_window[blk]) * w
        for lane in range(b):
            p = blk * b + lane
            if blocks.valid[p]:
                out[base + blocks.v_local[p]] += vals[p]
    return out[:num_nodes]


def _auto_spill_capacity(size: int) -> int:
    """Auto-sized spill tail: zero lanes when nothing spills, else rounded up
    to 1024 so buckets of one stream share one layout signature."""
    return 0 if size == 0 else -(-int(size) // 1024) * 1024


@dataclasses.dataclass
class LocalBlocks:
    """Graph-local layout of one bucket: a lane carries both in-window
    endpoints of one edge whose endpoints share a node window (every edge of
    a whole graph under window-aligned packing). In the ELL layout every
    window owns ``k_blocks`` blocks of ``block`` lanes; in the legacy
    dynamic-window layout (``build_local_blocks``, ``k_blocks`` 0) a window
    owns as many blocks as its edges need and ``block_window`` names each
    block's window. Edges that cross a window, or overflow their window's
    ELL lanes, go to the spill tail."""

    u_local: np.ndarray  # [P] int32 (sentinel ``window`` on pad lanes)
    v_local: np.ndarray  # [P] int32
    block_window: np.ndarray  # [num_blocks] int32 non-decreasing (ELL: block b → window b // k_blocks)
    edge_perm: np.ndarray  # [P] int32 into the original edge axis (pads → 0)
    valid: np.ndarray  # [P] bool
    spill: np.ndarray  # [spill capacity] int32 original-edge indices of spill edges
    window: int
    block: int
    spill_count: int  # real entries at the front of ``spill``
    k_blocks: int = 0

    @property
    def num_blocks(self) -> int:
        return int(self.block_window.shape[0])


def build_local_blocks(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_capacity: int,
    window: int = 128,
    block: int = 128,
    spill_capacity: int = 8192,
) -> LocalBlocks:
    """The legacy dynamic-window local layout: the edge-block layout of
    ``build_edge_blocks`` over the window-local edges, each lane with both
    in-window endpoints, and an un-blocked spill tail of ``spill_capacity``
    lanes for the edges that cross a window. More crossing edges than that
    raise ``ValueError``."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    real = receivers < num_nodes - 1  # row num_nodes − 1 is the pad node
    local_mask = real & (senders // window == receivers // window)
    spill_idx = np.nonzero(real & ~local_mask)[0].astype(np.int32)
    if spill_idx.size > spill_capacity:
        raise ValueError(
            f"spill capacity {spill_capacity} < {spill_idx.size} crossing edges"
        )
    spill = np.zeros(spill_capacity, np.int32)
    spill[: spill_idx.size] = spill_idx

    edge_perm, valid, block_window = _pack_window_blocks(
        np.nonzero(local_mask)[0], receivers, num_nodes, edge_capacity, window, block)
    u_local = _in_window(senders, edge_perm, valid, block_window, window, block)
    v_local = _in_window(receivers, edge_perm, valid, block_window, window, block)
    return LocalBlocks(
        u_local, v_local, block_window, edge_perm, valid, spill, window, block,
        spill_count=int(spill_idx.size),
    )


def build_local_blocks_ell(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    window: int = 128,
    block: int = 128,
    k_blocks: int | None = None,
    spill_capacity: int | None = None,
) -> LocalBlocks:
    """ELL variant of the graph-local layout. Within a window, lanes hold the
    window's local edges stably sorted by receiver, so each destination
    row's lanes are one contiguous run and the runs ascend with the row;
    pad lanes (u = v = ``window``) follow. ``k_blocks=None`` sizes k from
    the 95th percentile of per-window local-edge counts (at most 4);
    ``spill_capacity=None`` sizes the tail to the spill count rounded up to
    1024, zero when nothing spills. Row ``num_nodes − 1`` is the pad node:
    edges into it are dropped."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    real = receivers < num_nodes - 1
    local_mask = real & (senders // window == receivers // window)

    num_windows = -(-num_nodes // window)
    if k_blocks is None:
        counts = np.bincount(receivers[local_mask] // window, minlength=num_windows)
        p95 = float(np.percentile(counts, 95)) if counts.size else 0.0
        k_blocks = int(min(4, max(1, -(-p95 // block))))
    cap = k_blocks * block
    p = num_windows * cap
    u_local = np.full(p, window, np.int32)
    v_local = np.full(p, window, np.int32)
    edge_perm = np.zeros(p, np.int32)
    valid = np.zeros(p, np.bool_)

    loc = np.nonzero(local_mask)[0]
    order = loc[np.argsort(receivers[loc], kind="stable")]
    wids = receivers[order] // window

    spill_parts = [np.nonzero(real & ~local_mask)[0].astype(np.int32)]
    i = 0
    for w in range(num_windows):
        j = i
        while j < len(order) and wids[j] == w:
            j += 1
        take = min(j - i, cap)
        idx = order[i : i + take]
        base = w * cap
        u_local[base : base + take] = senders[idx] - w * window
        v_local[base : base + take] = receivers[idx] - w * window
        edge_perm[base : base + take] = idx
        valid[base : base + take] = True
        if j - i > take:  # overflow → spill
            spill_parts.append(order[i + take : j].astype(np.int32))
        i = j

    spill_idx = np.concatenate(spill_parts)
    if spill_capacity is None:
        spill_capacity = _auto_spill_capacity(spill_idx.size)
    if spill_idx.size > spill_capacity:
        raise ValueError(f"spill capacity {spill_capacity} < {spill_idx.size}")
    spill = np.zeros(spill_capacity, np.int32)
    spill[: spill_idx.size] = spill_idx
    block_window = (np.arange(num_windows * k_blocks) // k_blocks).astype(np.int32)
    return LocalBlocks(
        u_local, v_local, block_window, edge_perm, valid, spill, window, block,
        spill_count=int(spill_idx.size), k_blocks=k_blocks,
    )


def build_local_slots(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    window: int = 512,
    slots: int = 8,
    spill_capacity: int | None = None,
):
    """Dest-major slot layout.

    Within each node window, every destination row owns up to ``slots``
    in-edge slots holding the in-window source index (sentinel ``window``
    when empty). In-degree overflow and window-crossing edges go to the
    spill tail.

    Returns (slot_src [NW·W, S] int32, spill [spill_capacity] int32,
    spill_count int, slot_edge [NW·W, S] int32 — the original edge index
    each slot holds, −1 when empty).
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    real = receivers < num_nodes - 1
    local_mask = real & (senders // window == receivers // window)
    num_windows = -(-num_nodes // window)

    slot_src = np.full((num_windows * window, slots), window, np.int32)
    slot_edge = np.full((num_windows * window, slots), -1, np.int32)
    # Each local edge's slot is its rank among its receiver's local in-edges
    # in edge order: a stable sort by receiver keeps ascending edge order
    # within each group, so rank = position − first-occurrence index.
    loc = np.nonzero(local_mask)[0]
    order = loc[np.argsort(receivers[loc], kind="stable")]
    rv = receivers[order]
    rank = np.arange(rv.size) - np.searchsorted(rv, rv, side="left")
    ok = rank < slots
    slot_src[rv[ok], rank[ok]] = (
        senders[order[ok]] - (rv[ok] // window) * window
    )
    slot_edge[rv[ok], rank[ok]] = order[ok]
    overflow = np.sort(order[~ok])

    spill_idx = np.concatenate(
        [np.nonzero(real & ~local_mask)[0].astype(np.int32),
         np.asarray(overflow, np.int32)]
    ) if (overflow.size or (real & ~local_mask).any()) else np.zeros(
        0, np.int32
    )
    if spill_capacity is None:
        spill_capacity = _auto_spill_capacity(spill_idx.size)
    if spill_idx.size > spill_capacity:
        raise ValueError(f"spill capacity {spill_capacity} < {spill_idx.size}")
    spill = np.zeros(spill_capacity, np.int32)
    spill[: spill_idx.size] = spill_idx
    return slot_src, spill, int(spill_idx.size), slot_edge
