"""Graph-local layout builders (numpy only).

Copies of ``build_local_slots``, ``LocalBlocks``, ``build_local_blocks_ell``
and ``_auto_spill_capacity`` from ``flowgnn_tpu.core.blocking``. The ELL
builder is the JAX package's numpy loop, which is also the oracle of its
native packer (``runtime/packer.cc``, not ported): the same lanes. The
legacy dynamic-window and edge-block builders come with the slices that run
them (ROADMAP queue 2 C).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _auto_spill_capacity(size: int) -> int:
    """Auto-sized spill tail: zero lanes when nothing spills, else rounded up
    to 1024 so buckets of one stream share one layout signature."""
    return 0 if size == 0 else -(-int(size) // 1024) * 1024


@dataclasses.dataclass
class LocalBlocks:
    """ELL layout of one bucket: every window owns ``k_blocks`` blocks of
    ``block`` lanes; a lane carries both in-window endpoints of one edge.
    Edges that cross a window, or overflow their window's lanes, go to the
    spill tail."""

    u_local: np.ndarray  # [P] int32 (sentinel ``window`` on pad lanes)
    v_local: np.ndarray  # [P] int32
    block_window: np.ndarray  # [num_blocks] int32, block b → window b // k_blocks
    edge_perm: np.ndarray  # [P] int32 into the original edge axis (pads → 0)
    valid: np.ndarray  # [P] bool
    spill: np.ndarray  # [spill capacity] int32 original-edge indices of spill edges
    window: int
    block: int
    spill_count: int  # real entries at the front of ``spill``
    k_blocks: int

    @property
    def num_blocks(self) -> int:
        return int(self.block_window.shape[0])


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
