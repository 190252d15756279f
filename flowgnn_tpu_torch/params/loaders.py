"""GIN parameters: the reference weight parser, a seeded synthetic set, and
the conversion of a numpy parameter dict to the port's tensors.

Linear weights keep the reference's [out, in] convention; apply as
``x @ w.T + b``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.features import ATOM_FEATURE_TOTAL, BOND_FEATURE_TOTAL
from ..core.numerics import Precision


def _read(path: str, count: int, offset_floats: int = 0) -> np.ndarray:
    arr = np.fromfile(path, dtype="<f4", count=count, offset=4 * offset_floats)
    if arr.size != count:
        raise ValueError(f"{path}: expected {count} floats at offset {offset_floats}")
    return arr


def _gin_shapes(dim: int, hidden: int, layers: int) -> dict:
    """Key → shape of a GIN parameter dict, in the loader's key order."""
    return {
        "node_embedding": (ATOM_FEATURE_TOTAL, dim),
        "edge_embedding": (layers, BOND_FEATURE_TOTAL, dim),
        "eps": (layers,),
        "mlp1_w": (layers, hidden, dim),
        "mlp1_b": (layers, hidden),
        "mlp2_w": (layers, dim, hidden),
        "mlp2_b": (layers, dim),
        "pred_w": (1, dim),
        "pred_b": (1,),
    }


def load_gin(model_dir: str, dim: int = 100) -> dict:
    """GIN per-file layout (GIN/src/host_load.cc:18-98). dim=100, 5 layers."""
    p = lambda name: os.path.join(model_dir, f"gin_ep1_{name}_dim{dim}.bin")
    files = {
        "node_embedding": "nd_embed", "edge_embedding": "ed_embed",
        "eps": "eps", "mlp1_w": "mlp_1_weights", "mlp1_b": "mlp_1_bias",
        "mlp2_w": "mlp_2_weights", "mlp2_b": "mlp_2_bias",
        "pred_w": "pred_weights", "pred_b": "pred_bias",
    }
    return {
        k: _read(p(files[k]), int(np.prod(s))).reshape(s)
        for k, s in _gin_shapes(dim, 2 * dim, 5).items()
    }


def synthetic_gin_params(
    seed: int, dim: int = 100, hidden: int = 200, layers: int = 5
) -> dict:
    """Seeded stand-in for the reference GIN weights (which are not shipped
    with the repo): every entry drawn from N(0, 0.1²) as float32, with the
    keys and shapes of ``load_gin``."""
    rng = np.random.default_rng(seed)
    return {
        k: rng.normal(0, 0.1, s).astype(np.float32)
        for k, s in _gin_shapes(dim, hidden, layers).items()
    }


def params_from_numpy(params: dict, prec: Precision, device) -> dict:
    """Numpy parameter dict → tensors of ``prec.compute_dtype`` on ``device``.

    The counterpart of ``flowgnn_tpu.models.base.prepare_params`` in the
    float modes: weights pass through float32 first, exactly as the JAX
    package does, so both packages compute from identical values."""
    return {
        k: torch.as_tensor(
            np.asarray(v, np.float32), dtype=prec.compute_dtype, device=device
        )
        for k, v in params.items()
    }
