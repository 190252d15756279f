"""Graph containers and the static-shape packer (numpy only).

A copy of the parts of ``flowgnn_tpu.core.graphs`` that the slot main path
runs. The JAX package's module cannot be imported here: importing anything
under ``flowgnn_tpu`` imports ``jax``. ``tests/test_torch_host.py`` holds the
two copies' outputs equal. The models run GIN-VN's analytic virtual node
(``add_virtual_node_analytic``); the materialized one (``add_virtual_node``)
is there for datasets that want the star's edges written out.

``PackedGraphs`` is the jraph-style flat packing: all nodes of all graphs on
one axis of capacity ``node_capacity`` plus one trailing pad node, all edges
with global node indices and padded edges pointing at the pad node, per-graph
counts, and a per-node graph id for the readout.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from .features import NUM_ATOM_FEATURES, NUM_BOND_FEATURES


@dataclasses.dataclass
class Graph:
    """One graph in host memory (reference on-disk unit: g%d_*.bin)."""

    node_feat: np.ndarray  # [num_nodes, 9] int32 categorical atom features
    edge_index: np.ndarray  # [num_edges, 2] int32 (u, v) = (source, dest)
    edge_attr: Optional[np.ndarray] = None  # [num_edges, 3] int32 bond features
    node_eigen: Optional[np.ndarray] = None  # [num_nodes, 4] float32 (DGN)
    node_vn: Optional[np.ndarray] = None  # [num_nodes] bool — analytic-VN marker

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[0])


def add_virtual_node(g: Graph) -> Graph:
    """GIN-VN augmentation, materialized: one zero-feature node appended and
    connected to all (GIN-VN/src/host_load.cc:129,137-141,149-153): for every
    original node ``nd`` the two zero-attr edges ``(nd, N)`` and ``(N, nd)``,
    appended after the original edges."""
    n = g.num_nodes
    node_feat = np.concatenate(
        [g.node_feat, np.zeros((1, g.node_feat.shape[1]), dtype=g.node_feat.dtype)]
    )
    star = np.empty((2 * n, 2), dtype=g.edge_index.dtype)
    star[0::2, 0] = np.arange(n)
    star[0::2, 1] = n
    star[1::2, 0] = n
    star[1::2, 1] = np.arange(n)
    edge_index = np.concatenate([g.edge_index, star])
    edge_attr = None
    if g.edge_attr is not None:
        edge_attr = np.concatenate(
            [g.edge_attr, np.zeros((2 * n, g.edge_attr.shape[1]), g.edge_attr.dtype)]
        )
    return Graph(node_feat, edge_index, edge_attr, g.node_eigen)


def add_virtual_node_analytic(g: Graph) -> Graph:
    """GIN-VN augmentation with the star edges kept algebraic.

    One zero-feature node is appended and flagged in ``node_vn``; its 2N
    zero-attr star edges (GIN-VN/src/host_load.cc:129-153) are not
    materialized. Every star edge carries the same bond embedding e0, so the
    star's messages factor into a per-graph pooled sum (into the VN) and a
    per-graph broadcast (out of it), which ``models/gin.py`` computes.
    """
    n = g.num_nodes
    node_feat = np.concatenate(
        [g.node_feat, np.zeros((1, g.node_feat.shape[1]), dtype=g.node_feat.dtype)]
    )
    vn = np.zeros(n + 1, dtype=bool)
    vn[n] = True
    if g.node_vn is not None:
        vn[:n] = g.node_vn
    return Graph(node_feat, g.edge_index, g.edge_attr, g.node_eigen, vn)


def add_self_loops(g: Graph) -> Graph:
    """Prepend one self edge per node, with zero bond attributes: GAT seeds
    each node's in-list with it, self edge *first*
    (GAT/src/load_inputs.cc:144-149)."""
    loops = np.stack([np.arange(g.num_nodes)] * 2, axis=1).astype(g.edge_index.dtype)
    edge_index = np.concatenate([loops, g.edge_index])
    edge_attr = None
    if g.edge_attr is not None:
        edge_attr = np.concatenate(
            [
                np.zeros((g.num_nodes, g.edge_attr.shape[1]), g.edge_attr.dtype),
                g.edge_attr,
            ]
        )
    return Graph(g.node_feat, edge_index, edge_attr, g.node_eigen, g.node_vn)


def laplacian_eigenvectors(g: Graph, k: int = 4) -> Graph:
    """Attach the first ``k`` eigenvectors of L_sym = I − D^-1/2 A D^-1/2
    (ascending eigenvalues, dense ``eigh``, float32), which stand in for the
    reference's precomputed DGN ``eig/g%d.txt`` (DGN/src/host_load.cc:
    154-216); DGN reads component [1]. Eigenvectors are unique only up to
    sign and basis within a degenerate eigenvalue, so this is the JAX
    package's code line for line: the same LAPACK calls in the same order
    give the same vectors."""
    n = g.num_nodes
    a = np.zeros((n, n), dtype=np.float64)
    if g.num_edges:
        a[g.edge_index[:, 0], g.edge_index[:, 1]] = 1.0
    a = np.maximum(a, a.T)
    deg = a.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    lap = np.eye(n) - dinv[:, None] * a * dinv[None, :]
    _, vecs = np.linalg.eigh(lap)
    eig = np.zeros((n, k), dtype=np.float32)
    eig[:, : min(k, n)] = vecs[:, : min(k, n)]
    return Graph(g.node_feat, g.edge_index, g.edge_attr, eig, g.node_vn)


@dataclasses.dataclass
class PackedGraphs:
    """A fixed-capacity flat batch of graphs (all arrays statically shaped).

    Nodes of graph i occupy a contiguous range; the last node slot (index
    ``node_capacity``) is the pad node every padded edge points at.
    ``n_node``/``n_edge`` end with one pad graph that owns all pad nodes.
    """

    node_feat: np.ndarray  # [N+1, 9] int32
    node_graph: np.ndarray  # [N+1]   int32 graph id (pad nodes → G)
    senders: np.ndarray  # [E]     int32 global u (pad edges → N)
    receivers: np.ndarray  # [E]     int32 global v (pad edges → N)
    edge_attr: np.ndarray  # [E, 3]  int32 (zeros when model has none)
    n_node: np.ndarray  # [G+1]   int32 per-graph node counts (pad graph last)
    n_edge: np.ndarray  # [G+1]   int32
    node_eigen: Optional[np.ndarray] = None  # [N+1, 4] float32 (DGN)
    node_vn: Optional[np.ndarray] = None  # [N+1] bool — analytic virtual nodes

    @property
    def node_capacity(self) -> int:
        return int(self.node_feat.shape[0]) - 1

    @property
    def edge_capacity(self) -> int:
        return int(self.senders.shape[0])

    @property
    def num_graphs(self) -> int:
        """Number of real (non-pad) graphs."""
        return int(np.sum(self.n_node[:-1] > 0))


def _fill(graphs: Sequence[Graph], offsets: Sequence[int], node_capacity: int,
          edge_capacity: int, graph_capacity: int, with_eigen: bool) -> PackedGraphs:
    """Scatter ``graphs`` into fresh capacity-shaped arrays at ``offsets``;
    ``with_eigen`` packs each graph's first 4 eigenvector columns."""
    node_feat = np.zeros((node_capacity + 1, NUM_ATOM_FEATURES), np.int32)
    node_graph = np.full(node_capacity + 1, graph_capacity, np.int32)
    senders = np.full(edge_capacity, node_capacity, np.int32)
    receivers = np.full(edge_capacity, node_capacity, np.int32)
    edge_attr = np.zeros((edge_capacity, NUM_BOND_FEATURES), np.int32)
    n_node = np.zeros(graph_capacity + 1, np.int32)
    n_edge = np.zeros(graph_capacity + 1, np.int32)
    node_eigen = np.zeros((node_capacity + 1, 4), np.float32) if with_eigen else None
    with_vn = any(g.node_vn is not None for g in graphs)
    node_vn = np.zeros(node_capacity + 1, bool) if with_vn else None

    edge_off = 0
    for i, (g, node_off) in enumerate(zip(graphs, offsets)):
        n, e = g.num_nodes, g.num_edges
        node_feat[node_off : node_off + n] = g.node_feat
        node_graph[node_off : node_off + n] = i
        if with_vn and g.node_vn is not None:
            node_vn[node_off : node_off + n] = g.node_vn
        senders[edge_off : edge_off + e] = g.edge_index[:, 0] + node_off
        receivers[edge_off : edge_off + e] = g.edge_index[:, 1] + node_off
        if g.edge_attr is not None:
            edge_attr[edge_off : edge_off + e] = g.edge_attr
        if with_eigen:
            if g.node_eigen is None:
                raise ValueError("with_eigen=True but graph has no node_eigen")
            k = min(4, g.node_eigen.shape[1])
            node_eigen[node_off : node_off + n, :k] = g.node_eigen[:, :k]
        n_node[i] = n
        n_edge[i] = e
        edge_off += e

    # Pad nodes belong to the trailing pad graph; give it their count so that
    # segment readout over graph ids never divides by zero unexpectedly.
    n_node[graph_capacity] = node_capacity + 1 - int(n_node[:graph_capacity].sum())
    n_edge[graph_capacity] = edge_capacity - edge_off
    return PackedGraphs(
        node_feat, node_graph, senders, receivers, edge_attr, n_node, n_edge,
        node_eigen, node_vn,
    )


def _check_capacity(graphs, node_capacity, edge_capacity, graph_capacity):
    total_edges = sum(g.num_edges for g in graphs)
    if total_edges > edge_capacity:
        raise ValueError(f"edge capacity {edge_capacity} < {total_edges}")
    if len(graphs) > graph_capacity:
        raise ValueError(f"graph capacity {graph_capacity} < {len(graphs)}")


def pack_graphs(
    graphs: Sequence[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
    with_eigen: bool = False,
) -> PackedGraphs:
    """Pack ``graphs`` into one static-shape batch. Raises if capacity exceeded."""
    total_nodes = sum(g.num_nodes for g in graphs)
    if total_nodes > node_capacity:
        raise ValueError(f"node capacity {node_capacity} < {total_nodes}")
    _check_capacity(graphs, node_capacity, edge_capacity, graph_capacity)
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs[:-1]]).tolist()
    return _fill(graphs, offsets, node_capacity, edge_capacity, graph_capacity, with_eigen)


def pack_graphs_aligned(
    graphs: Sequence[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
    window: int = 128,
    with_eigen: bool = False,
) -> PackedGraphs:
    """Window-aligned packing: no graph smaller than ``window`` straddles a
    ``window``-node boundary, so all of its edges stay inside one window
    (the locality contract of the slot megakernel). Larger graphs pack
    contiguously; gap slots between graphs are pad nodes of the pad graph."""
    total_nodes = sum(g.num_nodes for g in graphs)
    if total_nodes > node_capacity:
        raise ValueError(f"node capacity {node_capacity} < {total_nodes}")

    offsets = []
    off = 0
    for g in graphs:
        n = g.num_nodes
        if n <= window:
            room = window - (off % window)
            if n > room:
                off += room  # advance to the next window boundary
        if off + n > node_capacity:
            raise ValueError("window alignment exceeded node capacity")
        offsets.append(off)
        off += n
    _check_capacity(graphs, node_capacity, edge_capacity, graph_capacity)
    return _fill(graphs, offsets, node_capacity, edge_capacity, graph_capacity, with_eigen)


def auto_edge_capacity(graphs: Sequence[Graph], node_capacity: int) -> int:
    """Edge capacity sized so ``node_capacity``-node buckets fit their
    edges (stream density × 1.15 headroom, 1024-aligned), so buckets fill
    their node axis instead of flushing early on edges."""
    total_n = sum(g.num_nodes for g in graphs)
    density = sum(g.num_edges for g in graphs) / max(1, total_n)
    return -(-int(node_capacity * density * 1.15) // 1024) * 1024


def pack_dataset(
    graphs: Iterable[Graph],
    node_capacity: int,
    edge_capacity: int,
    graph_capacity: int,
    with_eigen: bool = False,
    align_window: Optional[int] = None,
) -> Iterator[PackedGraphs]:
    """Greedy first-fit streaming packer: yields full buckets of fixed shape.
    ``align_window`` switches to window-aligned placement (see
    pack_graphs_aligned) and accounts for the alignment gaps while filling.
    """

    def aligned_usage(cur: int, n: int) -> int:
        if align_window and n <= align_window:
            room = align_window - (cur % align_window)
            if n > room:
                cur += room
        return cur + n

    def flush(bucket):
        if align_window:
            return pack_graphs_aligned(
                bucket, node_capacity, edge_capacity, graph_capacity,
                align_window, with_eigen,
            )
        return pack_graphs(
            bucket, node_capacity, edge_capacity, graph_capacity, with_eigen
        )

    bucket: list[Graph] = []
    nodes = edges = 0
    for g in graphs:
        new_nodes = aligned_usage(nodes, g.num_nodes)
        over = (
            new_nodes > node_capacity
            or edges + g.num_edges > edge_capacity
            or len(bucket) >= graph_capacity
        )
        if over and bucket:
            yield flush(bucket)
            bucket, nodes, edges = [], 0, 0
            new_nodes = aligned_usage(0, g.num_nodes)
        if g.num_nodes > node_capacity or g.num_edges > edge_capacity:
            raise ValueError("graph larger than bucket capacity")
        bucket.append(g)
        nodes = new_nodes
        edges += g.num_edges
    if bucket:
        yield flush(bucket)
