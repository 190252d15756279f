"""Readers/writers for the reference on-disk dataset formats.

The reference driver unpacks a dataset into (run_experiments.sh:9-26):

  graphs/graph_info/g%d_info.txt      — "%d\n%d" = num_nodes, num_edges
                                        (GIN/src/host.cc:126-131)
  graphs/graph_bin/g%d_node_feature.bin — int32 [num_nodes, 9]
  graphs/graph_bin/g%d_edge_list.bin    — int32 [num_edges, 2] (u, v) pairs
  graphs/graph_bin/g%d_edge_attr.bin    — int32 [num_edges, 3]
                                        (GIN/src/host_load.cc:100-143)
  DGN/eig/g%d.txt                       — torch-printed "tensor([[..]])" with 4
                                          Laplacian-eigenvector components per
                                          node (DGN/src/host_load.cc:154-216)

Graphs are numbered 1-based (GIN/src/host.cc:119). We read and write the same
layout so datasets round-trip between this framework and the reference hosts.

A copy of ``flowgnn_tpu.core.io`` (whose package imports jax): the same
files give the same graphs (``tests/test_torch_runtime.py``). The native
reader ``runtime.native.read_graph_native`` is held against ``read_graph``.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Optional, Sequence

import numpy as np

from .features import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from .graphs import Graph


def read_graph_info(path: str) -> tuple[int, int]:
    with open(path) as f:
        txt = f.read().split()
    return int(txt[0]), int(txt[1])


def read_eigen_txt(path: str, num_nodes: int) -> np.ndarray:
    """Parse the torch-printed eig/g%d.txt file into [num_nodes, 4] float32."""
    with open(path) as f:
        txt = f.read()
    vals = [float(x) for x in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", txt)]
    arr = np.asarray(vals, dtype=np.float32).reshape(num_nodes, 4)
    return arr


def write_eigen_txt(path: str, eig: np.ndarray) -> None:
    rows = [
        "[" + ", ".join(f"{v:.4e}" for v in row) + "]" for row in np.asarray(eig)
    ]
    with open(path, "w") as f:
        f.write("tensor([" + ",\n        ".join(rows) + "])")


def read_graph(
    dataset_dir: str, index: int, with_eigen: bool = False, eig_dir: Optional[str] = None
) -> Graph:
    """Read graph ``index`` (1-based) from a reference-layout dataset dir."""
    info = os.path.join(dataset_dir, "graph_info", f"g{index}_info.txt")
    num_nodes, num_edges = read_graph_info(info)
    base = os.path.join(dataset_dir, "graph_bin", f"g{index}")
    node_feat = np.fromfile(base + "_node_feature.bin", dtype=np.int32).reshape(
        num_nodes, NUM_ATOM_FEATURES
    )
    edge_index = np.fromfile(base + "_edge_list.bin", dtype=np.int32).reshape(
        num_edges, 2
    )
    attr_path = base + "_edge_attr.bin"
    edge_attr = None
    if os.path.exists(attr_path):
        edge_attr = np.fromfile(attr_path, dtype=np.int32).reshape(
            num_edges, NUM_BOND_FEATURES
        )
    node_eigen = None
    if with_eigen:
        eig_path = os.path.join(eig_dir or os.path.join(dataset_dir, "eig"), f"g{index}.txt")
        node_eigen = read_eigen_txt(eig_path, num_nodes)
    return Graph(node_feat, edge_index, edge_attr, node_eigen)


def write_graph(dataset_dir: str, index: int, g: Graph) -> None:
    """Write graph ``index`` (1-based) in the reference layout."""
    info_dir = os.path.join(dataset_dir, "graph_info")
    bin_dir = os.path.join(dataset_dir, "graph_bin")
    os.makedirs(info_dir, exist_ok=True)
    os.makedirs(bin_dir, exist_ok=True)
    with open(os.path.join(info_dir, f"g{index}_info.txt"), "w") as f:
        f.write(f"{g.num_nodes}\n{g.num_edges}")
    base = os.path.join(bin_dir, f"g{index}")
    g.node_feat.astype(np.int32).tofile(base + "_node_feature.bin")
    g.edge_index.astype(np.int32).tofile(base + "_edge_list.bin")
    if g.edge_attr is not None:
        g.edge_attr.astype(np.int32).tofile(base + "_edge_attr.bin")
    if g.node_eigen is not None:
        eig_dir = os.path.join(dataset_dir, "eig")
        os.makedirs(eig_dir, exist_ok=True)
        write_eigen_txt(os.path.join(eig_dir, f"g{index}.txt"), g.node_eigen)


def write_dataset(dataset_dir: str, graphs: Sequence[Graph]) -> None:
    for i, g in enumerate(graphs, start=1):
        write_graph(dataset_dir, i, g)
    with open(os.path.join(dataset_dir, "dataset_size.txt"), "w") as f:
        f.write(str(len(graphs)))


def read_dataset(
    dataset_dir: str, num_graphs: Optional[int] = None, with_eigen: bool = False
) -> Iterator[Graph]:
    """Stream a reference-layout dataset (1-based graph numbering)."""
    if num_graphs is None:
        size_file = os.path.join(dataset_dir, "dataset_size.txt")
        with open(size_file) as f:
            num_graphs = int(f.read().strip())
    for i in range(1, num_graphs + 1):
        yield read_graph(dataset_dir, i, with_eigen=with_eigen)
