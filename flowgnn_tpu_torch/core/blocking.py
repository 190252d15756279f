"""Dest-major slot layout builder (numpy only).

A copy of ``build_local_slots`` and ``_auto_spill_capacity`` from
``flowgnn_tpu.core.blocking``; the ELL and edge-block builders come with the
slices that run them (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import numpy as np


def _auto_spill_capacity(size: int) -> int:
    """Auto-sized spill tail: zero lanes when nothing spills, else rounded up
    to 1024 so buckets of one stream share one layout signature."""
    return 0 if size == 0 else -(-int(size) // 1024) * 1024


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
