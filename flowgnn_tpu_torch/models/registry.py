"""Model registry: name → (forward fn, loader, graph transforms).

The counterpart of ``flowgnn_tpu.models.registry`` for the models the port
runs so far: GIN, GIN-VN, GCN and PNA. DGN and GAT join with their slices
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from ..core import graphs as G
from ..params import loaders
from . import gcn, gin, pna


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    forward: Callable
    loader: Callable
    dim: int
    num_layers: int
    transforms: tuple[Callable, ...] = ()
    reference_dir: str = ""  # subdirectory name in the reference tree


MODELS: dict[str, ModelSpec] = {
    "gin": ModelSpec(
        "gin", gin.forward, loaders.load_gin, dim=100, num_layers=5,
        reference_dir="GIN",
    ),
    # Production transform: the analytic virtual node (models/gin.py).
    "gin-vn": ModelSpec(
        "gin-vn", gin.forward, loaders.load_gin, dim=100, num_layers=5,
        transforms=(G.add_virtual_node_analytic,), reference_dir="GIN-VN",
    ),
    "gcn": ModelSpec(
        "gcn", gcn.forward, loaders.load_gcn, dim=100, num_layers=5,
        reference_dir="GCN",
    ),
    "pna": ModelSpec(
        "pna", pna.forward, loaders.load_pna, dim=80, num_layers=4,
        reference_dir="PNA",
    ),
}


def get(name: str) -> ModelSpec:
    return MODELS[name]


def apply_transforms(spec: ModelSpec, gs: Sequence[G.Graph]) -> list[G.Graph]:
    out = []
    for g in gs:
        for t in spec.transforms:
            g = t(g)
        out.append(g)
    return out
