"""OGB raw CSVs → the reference's on-disk dataset layout and labels.

The port's own copy of ``flowgnn_tpu.core.ogb`` (whose package imports
jax): the same files in give the same files out, byte for byte
(``tests/test_torch_ogb_metrics.py``). OGB's graph-property datasets ship,
inside their ``raw/`` directory:

    num-node-list.csv[.gz]   one int per graph
    num-edge-list.csv[.gz]   one int per graph
    node-feat.csv[.gz]       9 comma-separated ints per node row
    edge.csv[.gz]            "u,v" per edge row (graph-local indices)
    edge-feat.csv[.gz]       3 ints per edge row (absent for featureless sets)
    graph-label.csv[.gz]     one label row per graph (may contain blanks)

``convert_ogb`` writes the reference layout (``core.io``) plus a
``labels.csv`` sidecar:

    python -m flowgnn_tpu_torch.cli convert --raw <ogb>/raw --out graphs/molhiv
    python -m flowgnn_tpu_torch.cli accuracy --model gin --dataset graphs/molhiv
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from . import io as gio
from .graphs import Graph, laplacian_eigenvectors


def _open(path: str):
    """``path``, or ``path.gz`` where that exists, opened as text."""
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt")
    return open(path)


def _read_csv_ints(path: str) -> np.ndarray:
    with _open(path) as f:
        rows = [
            [int(float(x)) for x in line.strip().split(",")]
            for line in f
            if line.strip()
        ]
    return np.asarray(rows, np.int32)


def load_ogb_raw(
    raw_dir: str, with_eigen: bool = False, limit: Optional[int] = None
) -> tuple[list[Graph], np.ndarray]:
    """Read an OGB raw/ directory into Graphs and a [graphs, tasks] float64
    label array (blank labels NaN). A set without ``edge-feat.csv`` gets
    zero bond features; ``limit`` caps the count."""
    n_nodes = _read_csv_ints(os.path.join(raw_dir, "num-node-list.csv")).ravel()
    n_edges = _read_csv_ints(os.path.join(raw_dir, "num-edge-list.csv")).ravel()
    node_feat = _read_csv_ints(os.path.join(raw_dir, "node-feat.csv"))
    edges = _read_csv_ints(os.path.join(raw_dir, "edge.csv"))
    ef_path = os.path.join(raw_dir, "edge-feat.csv")
    edge_feat = (
        _read_csv_ints(ef_path)
        if os.path.exists(ef_path) or os.path.exists(ef_path + ".gz")
        else None
    )
    with _open(os.path.join(raw_dir, "graph-label.csv")) as f:
        labels = np.asarray(
            [
                [float(x) if x.strip() else np.nan for x in line.split(",")]
                for line in f
                if line.strip("\n")
            ],
            np.float64,
        )

    graphs = []
    node_off = edge_off = 0
    count = len(n_nodes) if limit is None else min(limit, len(n_nodes))
    for i in range(count):
        n, e = int(n_nodes[i]), int(n_edges[i])
        g = Graph(
            node_feat[node_off : node_off + n],
            edges[edge_off : edge_off + e],
            edge_feat[edge_off : edge_off + e] if edge_feat is not None
            else np.zeros((e, 3), np.int32),
        )
        if with_eigen:
            g = laplacian_eigenvectors(g)
        graphs.append(g)
        node_off += n
        edge_off += e
    return graphs, labels[:count]


def convert_ogb(
    raw_dir: str,
    out_dir: str,
    with_eigen: bool = False,
    limit: Optional[int] = None,
) -> int:
    """OGB raw CSVs → reference dataset layout + labels.csv. Returns the
    number of graphs written."""
    graphs, labels = load_ogb_raw(raw_dir, with_eigen=with_eigen, limit=limit)
    gio.write_dataset(out_dir, graphs)
    np.savetxt(os.path.join(out_dir, "labels.csv"), labels, delimiter=",")
    return len(graphs)


def write_ogb_raw(raw_dir: str, graphs, labels: np.ndarray, gz: bool = False,
                  edge_feat: bool = True) -> None:
    """The inverse of ``load_ogb_raw``: ``graphs`` and their [graphs, tasks]
    labels (NaN written blank; a row of one blank is an empty line, which
    the reader skips) as an OGB raw/ directory, each file
    gzip-compressed with ``gz``, ``edge-feat.csv`` left out without
    ``edge_feat``. For tests and smoke runs, where no OGB download is at
    hand."""
    os.makedirs(raw_dir, exist_ok=True)

    def write(name: str, lines) -> None:
        path = os.path.join(raw_dir, name)
        with (gzip.open(path + ".gz", "wt") if gz else open(path, "w")) as f:
            f.writelines(lines)

    rows = lambda arrs: (",".join(map(str, r)) + "\n" for a in arrs for r in np.asarray(a))
    write("num-node-list.csv", (f"{g.num_nodes}\n" for g in graphs))
    write("num-edge-list.csv", (f"{g.num_edges}\n" for g in graphs))
    write("node-feat.csv", rows(g.node_feat for g in graphs))
    write("edge.csv", rows(g.edge_index for g in graphs))
    if edge_feat:
        write("edge-feat.csv", rows(g.edge_attr for g in graphs))
    write("graph-label.csv", (",".join("" if np.isnan(x) else f"{x:g}" for x in row) + "\n"
                              for row in np.asarray(labels, np.float64).reshape(len(graphs), -1)))


def load_labels(dataset_dir: str) -> Optional[np.ndarray]:
    """A converted dataset's [graphs, tasks] labels, or None without
    ``labels.csv``."""
    path = os.path.join(dataset_dir, "labels.csv")
    if not os.path.exists(path):
        return None
    return np.loadtxt(path, delimiter=",", ndmin=2)
