"""Synthetic molhiv-like graph generator (numpy only).

A copy of ``flowgnn_tpu.core.synthetic``: the same seed gives the same graphs
(``tests/test_torch_host.py`` holds them equal). The graphs match the molhiv
shape statistics pinned in the reference's analysis constants
(GIN/src/dcl.h:37-55: 4113 graphs, nodes min/avg/max = 6/25/183, edges stored
directed with both directions present); features are uniform draws from the
OGB vocab sizes. DGN's eigenvector option comes with the DGN slice.
"""

from __future__ import annotations

import numpy as np

from .features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from .graphs import Graph

MOLHIV_NUM_GRAPHS = 4113
MOLHIV_AVG_NODES = 25


def random_molecule_graph(
    rng: np.random.Generator, num_nodes: int | None = None
) -> Graph:
    """One random molecule-shaped graph: a connected chain plus extra bonds,
    every bond stored as two directed edges (the OGB convention)."""
    if num_nodes is None:
        num_nodes = int(np.clip(rng.lognormal(np.log(MOLHIV_AVG_NODES), 0.45), 6, 183))
    n = num_nodes
    perm = rng.permutation(n)
    bonds = {(min(int(perm[i]), int(perm[i + 1])), max(int(perm[i]), int(perm[i + 1])))
             for i in range(n - 1)}
    # Extra chords: molhiv has ~= 0.12 * n rings/extra bonds.
    num_extra = rng.poisson(max(1, n // 8))
    for _ in range(num_extra):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            bonds.add((min(int(u), int(v)), max(int(u), int(v))))
    bonds = sorted(bonds)
    edge_index = np.empty((2 * len(bonds), 2), dtype=np.int32)
    edge_index[0::2, 0] = [b[0] for b in bonds]
    edge_index[0::2, 1] = [b[1] for b in bonds]
    edge_index[1::2, 0] = [b[1] for b in bonds]
    edge_index[1::2, 1] = [b[0] for b in bonds]

    node_feat = np.stack(
        [rng.integers(0, d, size=n) for d in ATOM_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    # Per-bond attributes, identical in both directions (OGB stores it so).
    bond_attr = np.stack(
        [rng.integers(0, d, size=len(bonds)) for d in BOND_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    edge_attr = np.repeat(bond_attr, 2, axis=0)
    return Graph(node_feat, edge_index, edge_attr)


def synthetic_molhiv(
    num_graphs: int = MOLHIV_NUM_GRAPHS, seed: int = 0
) -> list[Graph]:
    rng = np.random.default_rng(seed)
    return [random_molecule_graph(rng) for _ in range(num_graphs)]


# Dataset-shape profiles for the reference's three benchmark datasets
# (run_experiments.sh:51).
DATASET_PROFILES = {
    "molhiv": dict(num_graphs=4113, mean_nodes=25),
    "molpcba": dict(num_graphs=43793, mean_nodes=25),
    "hep10k": dict(num_graphs=10000, mean_nodes=90),
}


def synthetic_dataset(
    profile: str, seed: int = 0, num_graphs: int | None = None
) -> list[Graph]:
    cfg = DATASET_PROFILES[profile]
    rng = np.random.default_rng(seed)
    n = num_graphs if num_graphs is not None else cfg["num_graphs"]
    out = []
    for _ in range(n):
        nodes = int(
            np.clip(rng.lognormal(np.log(cfg["mean_nodes"]), 0.45), 6, 400)
        )
        out.append(random_molecule_graph(rng, num_nodes=nodes))
    return out
