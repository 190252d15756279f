"""Model registry: name → (forward fn, loader, graph transforms).

The counterpart of ``flowgnn_tpu.models.registry`` for the six models: GIN,
GIN-VN, GCN, GAT, PNA and DGN. Host-side graph transforms stand in for what
the reference does in host code (GIN-VN's virtual node), on the device at
load time (GAT's self edges) or ships precomputed (DGN's eigenvectors).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from ..core import graphs as G
from ..core.numerics import AP_FIXED_16_3, AP_FIXED_16_6, FixedSpec
from ..params import loaders
from . import dgn, gat, gcn, gin, pna


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    forward: Callable
    loader: Callable
    dim: int
    num_layers: int
    transforms: tuple[Callable, ...] = ()
    needs_eigen: bool = False
    # The reference's ap_fixed grid for the fixed mode (GIN/src/dcl.h:58-59,
    # DGN/src/dcl.h:54-55): Precision(fixed=spec.fixed_spec).
    fixed_spec: FixedSpec = AP_FIXED_16_6
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
    "gat": ModelSpec(
        "gat", gat.forward, loaders.load_gat, dim=16, num_layers=5,
        transforms=(G.add_self_loops,), reference_dir="GAT",
    ),
    "pna": ModelSpec(
        "pna", pna.forward, loaders.load_pna, dim=80, num_layers=4,
        reference_dir="PNA",
    ),
    "dgn": ModelSpec(
        "dgn", dgn.forward, loaders.load_dgn, dim=100, num_layers=4,
        needs_eigen=True, fixed_spec=AP_FIXED_16_3, reference_dir="DGN",
    ),
}


def get(name: str) -> ModelSpec:
    return MODELS[name]


def apply_transforms(spec: ModelSpec, gs: Sequence[G.Graph]) -> list[G.Graph]:
    out = []
    for g in gs:
        if spec.needs_eigen and g.node_eigen is None:
            g = G.laplacian_eigenvectors(g)
        for t in spec.transforms:
            g = t(g)
        out.append(g)
    return out
