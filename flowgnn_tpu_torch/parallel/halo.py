"""Halo-exchange edge sharding: the node-partitioned layout, built on the host.

The counterpart of ``flowgnn_tpu.parallel.halo``, in numpy over the port's
``core.blocking``. The reference partitions edges across scatter PEs by
destination (``pe_id = v % EDGE_PARALLEL``, GIN/src/load_inputs.cc:127); the
sharded mapping partitions a bucket's nodes across k ranks and exchanges
only the boundary rows, not the whole node array:

  * the padded node axis (N+1 rows) splits into ``k`` contiguous,
    window-aligned shards of ``S`` rows: rank i owns rows [i·S, (i+1)·S);
  * every real edge is owned by the rank of its receiver; the per-rank edge
    arrays are padded to a static capacity, pad lanes scatter into a
    per-rank trash row (local index S, sliced off after the reduction);
  * for each ordered rank pair (j → i) the unique rows rank j must ship to
    rank i are listed in ``halo_send_idx[j, i, :H]`` (static halo capacity
    H); remote senders are re-indexed into the receiving rank's extended
    node space [local rows 0..S) ‖ halo rows S + j·H + slot);
  * in / out-degrees are precomputed per node.

At run time (``models.base.halo_exchange``) each layer does one all-to-all
of the [k, H, D] boundary rows, and every segment reduction stays local to
the rank. The readout's one collective is an all-reduce of the [G+1, D]
graph partials, or a tiled all-gather of the per-shard pool partials.

The layouts equal the JAX package's key by key, except ``slot_stack``,
which is int32 here (the form the port's GAT slot kernels read), where the
JAX package stores bfloat16 or float32. ``halo_batches_uniform`` checks that
its second build gives one signature, and raises if it does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.blocking import build_local_blocks_ell, build_local_slots
from ..core.graphs import PackedGraphs
from ..models.base import ELL_DEFAULT_GEOMETRY, MAX_SLOTS, batch_signature, pool_layout

# Defaults chosen for molecule-scale graphs: a straddling graph contributes
# at most its node count of boundary rows per rank pair.
DEFAULT_HALO_CAP = 256
EDGE_SLACK = 1.5  # per-rank edge capacity headroom over the uniform share


@dataclasses.dataclass
class HaloShape:
    k: int
    rows_per_chip: int  # S
    edge_cap_per_chip: int  # Ec
    halo_cap: int  # H


def halo_shape(
    node_capacity: int,
    edge_capacity: int,
    k: int,
    window: int = 128,
    halo_cap: int = DEFAULT_HALO_CAP,
    edge_slack: float = EDGE_SLACK,
) -> HaloShape:
    """The static per-rank shape: a function of the bucket capacities alone,
    so every bucket of a stream shares one layout."""
    n = node_capacity + 1
    s = -(-n // (k * window)) * window
    ec = -(-int(edge_capacity / k * edge_slack) // 8) * 8
    return HaloShape(k, s, ec, halo_cap)


def halo_batches_uniform(buckets, k: int, blocked: str | None = None, **kw) -> list[dict]:
    """``build_halo_batch`` over a bucket stream, with the content-derived
    layout parameters (slot depth, ELL k, spill lanes) pinned to the
    stream's maxima, so every bucket shares one layout signature (the halo
    counterpart of ``models.base.as_batches_uniform``; what
    ``parallel.inference.stack_halo_buckets`` needs to stack a data axis of
    different buckets). Window-aligned streams, where nothing spills, pin
    only the slot or ELL depth, so the whole-model kernels still run per
    shard. Raises ``ValueError`` when the pinned rebuild still gives more
    than one signature."""
    hbs = [build_halo_batch(b, k=k, blocked=blocked, **kw) for b in buckets]
    if len(hbs) < 2 or len({batch_signature(hb) for hb in hbs}) == 1:
        return hbs
    pins: dict = {}
    if blocked == "local_slots":
        pins["slots"] = max(hb["slot_geom"].shape[-1] for hb in hbs)
        pins["spill_lanes"] = max(hb["slot_spill"].shape[-1] for hb in hbs)
    elif blocked == "local_ell":
        pins["k_blocks"] = max(hb["loc_ell"].shape[-1] for hb in hbs)
        pins["spill_lanes"] = max(
            hb["senders"].shape[-1] - hb["loc_ulocal"].shape[-1] for hb in hbs)
    hbs = [build_halo_batch(b, k=k, blocked=blocked, **pins, **kw) for b in buckets]
    sigs = {batch_signature(hb) for hb in hbs}
    if len(sigs) != 1:
        keys = sorted({key for sig in sigs for key in sig} - set.intersection(*map(set, sigs)))
        raise ValueError(
            f"halo batches of one stream keep {len(sigs)} layout signatures after "
            f"pinning {pins or 'nothing'}; they differ in {keys[:4]}")
    return hbs


def _ell_senders(s_ext: np.ndarray, s_rows: int) -> np.ndarray:
    """The senders handed to the ELL layout over the S+1 local rows: a halo
    sender (extended index ≥ S) becomes the trash row S, which no real
    receiver's window holds, so the edge is classed as crossing and goes to
    the spill tail exactly as its extended index would send it (the native
    layout routine takes node ids inside its rows only)."""
    return np.minimum(s_ext, s_rows)


def _pinned_spill(used: int, pinned: int | None) -> int:
    """The spill tail's lanes: ``used``, or a pinned count
    (``halo_batches_uniform``), which must hold this bucket's tail."""
    if pinned is None:
        return used
    if pinned < used:
        raise ValueError(f"pinned spill_lanes {pinned} < required {used}")
    return pinned


def build_halo_batch(
    packed: PackedGraphs,
    k: int,
    window: int = 128,
    halo_cap: int = DEFAULT_HALO_CAP,
    edge_slack: float = EDGE_SLACK,
    blocked: str | None = None,
    k_blocks: int | None = None,
    spill_cap: int = 4096,
    slots: int | None = None,
    spill_lanes: int | None = None,
) -> dict:
    """PackedGraphs → per-rank stacked batch dict (leading axis k).

    Keys split over the edge axis: node_feat [k,S,9], node_graph [k,S],
    node_eigen [k,S,4]?, senders [k,Ec] (extended space), receivers [k,Ec]
    (local space, trash = S), edge_attr [k,Ec,3], halo_send_idx [k,k,H],
    in_deg / out_deg [k,S], vn_mask [k,S]?. Replicated keys: n_node,
    n_edge [G+1] (and pool_row).

    ``blocked="local_ell"`` / ``"local_slots"`` also builds the graph-local
    layout of the ELL or slot kernels per shard (the shards are
    window-aligned by construction), so the kernels that run one bucket run
    each shard: halo-sourced edges fall to the spill tail, because their
    extended sender never shares a window with a local receiver. The
    per-rank edge arrays are then [lanes ‖ spill], as ``models.base.
    as_batch``'s local layouts are. Those layouts take the ELL window and
    block of ``models.base.ELL_DEFAULT_GEOMETRY`` (the JAX package's
    PALLAS_ELL_WINDOW / PALLAS_ELL_BLOCK); ``window`` is forced to that
    window, so the shards align with the kernels' windows. The per-shard slot
    layout is not degree-sorted: it has no prefix layout (``slot_meta``,
    ``slot_pcap_k``), and the slot kernels run it with ``prefix_caps=None``.
    Raises ``ValueError`` where a rank owns more edges than ``edge_slack``
    allows or a rank pair more boundary rows than ``halo_cap``.
    """
    if blocked in ("local_ell", "local_slots"):
        window = ELL_DEFAULT_GEOMETRY[0]
    shape = halo_shape(packed.node_capacity, packed.edge_capacity, k, window, halo_cap,
                       edge_slack)
    s_rows, ec, hcap = shape.rows_per_chip, shape.edge_cap_per_chip, shape.halo_cap
    n = packed.node_capacity + 1
    g_cap = packed.n_node.shape[0] - 1  # the pad graph's id
    n2 = k * s_rows

    def pad_nodes(arr, fill):
        out = np.full((n2,) + arr.shape[1:], fill, arr.dtype)
        out[:n] = arr
        return out

    node_feat = pad_nodes(packed.node_feat, 0).reshape(k, s_rows, -1)
    node_graph = pad_nodes(packed.node_graph, g_cap).reshape(k, s_rows)
    node_eigen = None
    if packed.node_eigen is not None:
        node_eigen = pad_nodes(packed.node_eigen, 0.0).reshape(k, s_rows, -1)

    senders = np.asarray(packed.senders)
    receivers = np.asarray(packed.receivers)
    edge_attr = np.asarray(packed.edge_attr)
    real = receivers < n - 1  # edges into the pad node are dropped

    in_deg = np.bincount(receivers[real], minlength=n2).astype(np.int32)
    out_deg = np.bincount(senders[real], minlength=n2).astype(np.int32)

    send_idx = np.zeros((k, k, hcap), np.int32)

    owner = receivers // s_rows
    per_chip = []
    for i in range(k):
        ei = np.nonzero(real & (owner == i))[0]
        if ei.size > ec:
            raise ValueError(
                f"edge capacity/chip {ec} < {ei.size} edges owned by chip {i}"
                " — raise edge_slack"
            )
        src = senders[ei]
        peer = src // s_rows
        s_ext = src - i * s_rows  # provisional: local coordinates
        for j in range(k):
            if j == i:
                continue
            rem = peer == j
            if not rem.any():
                continue
            rows = np.unique(src[rem])
            if rows.size > hcap:
                raise ValueError(
                    f"halo capacity {hcap} < {rows.size} boundary rows"
                    f" for chip pair {j}->{i} — raise halo_cap"
                )
            send_idx[j, i, : rows.size] = rows - j * s_rows
            slot = np.searchsorted(rows, src[rem])
            s_ext[rem] = s_rows + j * hcap + slot
        per_chip.append((ei, s_ext, receivers[ei] - i * s_rows))

    extras: dict = {}
    if blocked == "local_ell":
        block = ELL_DEFAULT_GEOMETRY[1]

        def ell(s_ext, r_loc, kb):
            return build_local_blocks_ell(
                _ell_senders(s_ext, s_rows), r_loc, s_rows + 1, window=window, block=block,
                k_blocks=kb, spill_capacity=spill_cap,
            )

        if k_blocks is None:
            # Build once, each rank sizing its own k, then rebuild only the
            # ranks whose k is below the largest (usually none).
            lbs = [ell(s_ext, r_loc, None) for _, s_ext, r_loc in per_chip]
            k_blocks = max(lb.k_blocks for lb in lbs)
            lbs = [lb if lb.k_blocks == k_blocks else ell(s_ext, r_loc, k_blocks)
                   for lb, (_, s_ext, r_loc) in zip(lbs, per_chip)]
        else:
            lbs = [ell(s_ext, r_loc, k_blocks) for _, s_ext, r_loc in per_chip]
        # The layout is built over s_rows + 1 local rows (the + 1 is the
        # trash row), so it carries one extra, always-empty trailing window
        # of pad lanes. The kernels take their grid from h's s_rows rows:
        # trim the trash window's lanes so that layout and kernel agree, or
        # a shard of more than one window mis-chunks its lanes.
        nw_shard = s_rows // window
        p_full = lbs[0].u_local.shape[0]
        blk = p_full // ((nw_shard + 1) * lbs[0].k_blocks)
        p_lanes = nw_shard * lbs[0].k_blocks * blk
        for lb in lbs:
            assert not lb.valid[p_lanes:].any(), "trash window held real lanes"
        # The spill tail sized to the largest rank's crossing edges (8-aligned;
        # 0 when a window-aligned packing spills nothing, so the whole-model
        # kernels still run per shard).
        sp_used = max(lb.spill_count for lb in lbs)
        sp_used = -(-sp_used // 8) * 8 if sp_used else 0
        sp_used = _pinned_spill(sp_used, spill_lanes)
        sh_send = np.zeros((k, p_lanes + sp_used), np.int32)
        sh_recv = np.full((k, p_lanes + sp_used), s_rows, np.int32)
        sh_attr = np.zeros((k, p_lanes + sp_used, edge_attr.shape[1]), np.int32)
        for i, ((ei, s_ext, r_loc), lb) in enumerate(zip(per_chip, lbs)):
            val = lb.valid[:p_lanes]
            perm = lb.edge_perm[:p_lanes]
            sh_send[i, :p_lanes][val] = s_ext[perm[val]]
            sh_recv[i, :p_lanes][val] = r_loc[perm[val]]
            sh_attr[i, :p_lanes][val] = edge_attr[ei[perm[val]]]
            nsp = lb.spill_count
            sp = lb.spill[:nsp]
            sh_send[i, p_lanes : p_lanes + nsp] = s_ext[sp]
            sh_recv[i, p_lanes : p_lanes + nsp] = r_loc[sp]
            sh_attr[i, p_lanes : p_lanes + nsp] = edge_attr[ei[sp]]
        extras["loc_ulocal"] = np.stack([lb.u_local[:p_lanes] for lb in lbs])
        extras["loc_vlocal"] = np.stack([lb.v_local[:p_lanes] for lb in lbs])
        # The (window, k) marker of the ELL geometry: its trailing two dims
        # survive the leading rank axis (models.base.ell_geometry).
        extras["loc_ell"] = np.zeros((k, window, k_blocks), np.int32)
    else:
        sh_send = np.full((k, ec), 0, np.int32)
        sh_recv = np.full((k, ec), s_rows, np.int32)  # trash row
        sh_attr = np.zeros((k, ec, edge_attr.shape[1]), np.int32)
        for i, (ei, s_ext, r_loc) in enumerate(per_chip):
            sh_send[i, : ei.size] = s_ext
            sh_recv[i, : ei.size] = r_loc
            sh_attr[i, : ei.size] = edge_attr[ei]
        if blocked == "local_slots":
            # The same trim of the trash window as the ELL branch: the slot
            # table is built over s_rows + 1 rows, the kernels grid over
            # s_rows.
            nw_shard = s_rows // window
            keep = nw_shard * window  # rows of the [NW·W, S] table
            # The slot depth from the stream's largest local in-degree
            # (deeper in-degrees ride the spill tail), as as_batch sizes it.
            s_needed = 1
            for _, s_ext, r_loc in per_chip:
                loc = (s_ext < s_rows) & (s_ext // window == r_loc // window)
                if loc.any():
                    s_needed = max(s_needed, int(np.bincount(
                        r_loc[loc], minlength=s_rows + 1).max()))
            s_slots = slots or max(1, min(s_needed, MAX_SLOTS))
            slot_u, slot_sp, slot_cnt = [], [], []
            for ei, s_ext, r_loc in per_chip:
                us, sp, cnt, _ = build_local_slots(
                    s_ext, r_loc, s_rows + 1, window=window, slots=s_slots,
                    spill_capacity=spill_cap,
                )
                assert (us[keep:] == window).all(), "trash window had slots"
                slot_u.append(us[:keep])  # [NW·W, S] per-dest rows
                slot_sp.append(sp)
                slot_cnt.append(cnt)
            # The spill tail sized to the largest rank's (0 when clean).
            sp_used = max(slot_cnt)
            sp_used = -(-sp_used // 8) * 8 if sp_used else 0
            sp_used = _pinned_spill(sp_used, spill_lanes)
            extras["slot_src"] = np.stack(slot_u)
            extras["slot_spill"] = np.stack([sp[:sp_used] for sp in slot_sp])
            extras["slot_spill_mask"] = np.stack(
                [np.arange(sp_used) < cnt for cnt in slot_cnt]
            )
            extras["slot_geom"] = np.zeros((k, window, s_slots), np.int32)
            # GAT's stacked-gather layout, [NW·S·W] per shard (slot-major in
            # each window), int32 as ``models.base.as_batch`` builds it.
            extras["slot_stack"] = np.stack([
                np.ascontiguousarray(
                    us.reshape(nw_shard, window, s_slots).transpose(0, 2, 1)
                ).reshape(-1)
                for us in slot_u
            ])

    batch = {
        "node_feat": node_feat,
        "node_graph": node_graph,
        "senders": sh_send,
        "receivers": sh_recv,
        "edge_attr": sh_attr,
        "halo_send_idx": send_idx,
        "in_deg": in_deg.reshape(k, s_rows),
        "out_deg": out_deg.reshape(k, s_rows),
        "n_node": np.asarray(packed.n_node),
        "n_edge": np.asarray(packed.n_edge),
    }
    batch.update(extras)
    if node_eigen is not None:
        batch["node_eigen"] = node_eigen
    if packed.node_vn is not None:
        # The analytic virtual node's flag shards with the node rows.
        batch["vn_mask"] = pad_nodes(packed.node_vn, False).reshape(k, s_rows)
    if blocked in ("local_ell", "local_slots"):
        # The in-kernel pooling layout per shard: window-aligned packing keeps
        # each graph in one window, hence one rank, so the global layout
        # splits cleanly: pool_gl shards with the node rows, pool_row (each
        # graph's row of the global partials) is replicated, and the models
        # complete the per-shard [NW·GMAX, T] partials with one tiled
        # all-gather (models.base.pool_gather).
        ids = pad_nodes(packed.node_graph, g_cap)
        real = ids < g_cap
        aligned = True
        if real.any():
            first = np.full(g_cap + 1, n2 - 1, np.int64)
            last = np.zeros(g_cap + 1, np.int64)
            np.minimum.at(first, ids, np.arange(n2))
            np.maximum.at(last, ids, np.arange(n2))
            gr = np.nonzero((first <= last)[:g_cap])[0]
            aligned = bool(np.all(first[gr] // window == last[gr] // window))
        layout = pool_layout(ids, g_cap + 1, window) if aligned else None
        if layout is not None:
            gl, row = layout
            batch["pool_gl"] = np.asarray(gl).reshape(k, s_rows)
            batch["pool_row"] = row  # global: replicated across ranks
    return batch


def halo_bytes_per_layer(shape: HaloShape, dim: int, dtype_bytes: int = 4) -> int:
    """Bytes one rank sends per layer in the halo exchange."""
    return shape.k * shape.halo_cap * dim * dtype_bytes


def exchange_width(model: str) -> int:
    """Columns of a row that ``model``'s sharded step ships a layer: h, D
    wide; GAT's [h ‖ s_tgt] on the halo path and [Σ score·h_u ‖ Σ score] on
    the replicated-node path (``models.gat``), 4 heads × 16 and the 4 heads'
    scores."""
    from ..models import registry

    dim = registry.get(model).dim
    return dim * 4 + 4 if model == "gat" else dim


def exchange_bytes_per_layer(shape: HaloShape, model: str, prec) -> int:
    """Bytes one rank of ``model``'s halo step sends a layer
    (``halo_bytes_per_layer``): ``exchange_width`` columns in ``prec``'s
    compute dtype, the dtype the exchanged rows have."""
    return halo_bytes_per_layer(shape, exchange_width(model), prec.compute_dtype.itemsize)


def psum_bytes_per_layer(node_capacity: int, dim: int, dtype_bytes: int = 4) -> int:
    """Bytes one rank's all-reduce of the full node array covers per layer
    on the replicated-node path (``parallel.inference.sharded_forward``)."""
    return (node_capacity + 1) * dim * dtype_bytes
