"""Model parameters: the reference weight parsers, seeded synthetic sets, and
the conversion of a numpy parameter dict to the port's tensors.

GIN and GAT read per-file weights (GIN/src/host_load.cc:18-98,
GAT/src/host_load.cc:14-98); GCN, PNA and DGN read hard-coded ``fseek``
float-offset maps into one ``*.weights.all.bin`` (GCN/src/host_load.cc:31-190,
PNA/src/host_load.cc:22-68, DGN/src/host_load.cc:5-151), as
``flowgnn_tpu.params.loaders`` does. Linear weights keep the reference's
[out, in] convention; apply as ``x @ w.T + b``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.features import ATOM_FEATURE_DIMS, ATOM_FEATURE_TOTAL, BOND_FEATURE_TOTAL
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


def _gcn_shapes(dim: int, layers: int) -> dict:
    """Key → shape of a GCN parameter dict, in the loader's key order."""
    return {
        "node_embedding": (ATOM_FEATURE_TOTAL, dim),
        "edge_embedding": (layers, BOND_FEATURE_TOTAL, dim),
        "conv_w": (layers, dim, dim),
        "conv_b": (layers, dim),
        "root_emb": (layers, dim),
        "bn_weight": (layers, dim),
        "bn_bias": (layers, dim),
        "bn_mean": (layers, dim),
        "bn_var": (layers, dim),
        "pred_w": (1, dim),
        "pred_b": (1,),
    }


def load_gcn(model_dir: str, dim: int = 100) -> dict:
    """GCN fseek-offset map into gcn_ep1_dim100.weights.all.bin
    (GCN/src/host_load.cc:31-190). Per layer l: conv_w at 17300+11500*l,
    conv_b +10000, root_emb +10100, edge_emb +10200; BN blocks at 74800+401*l
    (the +1 stride skips torch's num_batches_tracked counter)."""
    f = os.path.join(model_dir, f"gcn_ep1_dim{dim}.weights.all.bin")
    out = {k: np.zeros(s, np.float32) for k, s in _gcn_shapes(dim, 5).items()}
    out["node_embedding"] = _read(f, ATOM_FEATURE_TOTAL * dim).reshape(-1, dim)
    for l in range(5):
        base = 17300 + 11500 * l
        out["conv_w"][l] = _read(f, dim * dim, base).reshape(dim, dim)
        out["conv_b"][l] = _read(f, dim, base + 10000)
        out["root_emb"][l] = _read(f, dim, base + 10100)
        out["edge_embedding"][l] = _read(f, BOND_FEATURE_TOTAL * dim, base + 10200).reshape(-1, dim)
        bn = 74800 + 401 * l
        for i, key in enumerate(("bn_weight", "bn_bias", "bn_mean", "bn_var")):
            out[key][l] = _read(f, dim, bn + 100 * i)
    out["pred_w"] = _read(f, dim, 76805).reshape(1, dim)
    out["pred_b"] = _read(f, 1, 76905)
    return out


def synthetic_gcn_params(seed: int, dim: int = 100, layers: int = 5) -> dict:
    """Seeded stand-in for the reference GCN weights, with the keys and
    shapes of ``load_gcn``: every entry from N(0, 0.1²) as float32, except
    the BatchNorm's ``bn_var`` = 1 + |N(0, 0.1²)|, which it divides by the
    root of and so must stay positive, and ``bn_weight`` = 1 + N(0, 0.1²),
    near the identity as trained BatchNorm scales are (at 0.1 each layer
    would shrink h tenfold)."""
    rng = np.random.default_rng(seed)
    out = {
        k: rng.normal(0, 0.1, s).astype(np.float32)
        for k, s in _gcn_shapes(dim, layers).items()
    }
    out["bn_var"] = (1 + np.abs(out["bn_var"])).astype(np.float32)
    out["bn_weight"] = (1 + out["bn_weight"]).astype(np.float32)
    return out


# The host-side average log-degree constant of the reference PNA
# (PNA/src/host_load.cc:127).
PNA_AVG_DEG = 6.885701656341553


def _pna_shapes(dim: int, layers: int) -> dict:
    """Key → shape of a PNA parameter dict, in the loader's key order.
    conv_w is [l][dim_out][scaler][aggr][dim_in] with scalers (none, t,
    scale) and aggregators (mean, min, max, std), PNA/src/dcl.h:29-42."""
    return {
        "node_embedding": (ATOM_FEATURE_TOTAL, dim),
        "conv_w": (layers, dim, 3, 4, dim),
        "conv_b": (layers, dim),
        "mlp1_w": (40, dim),
        "mlp1_b": (40,),
        "mlp2_w": (20, 40),
        "mlp2_b": (20,),
        "mlp3_w": (1, 20),
        "mlp3_b": (1,),
    }


def load_pna(model_dir: str, dim: int = 80) -> dict:
    """PNA fseek map into pna_ep1_noBN_dim80.weights.all.bin
    (PNA/src/host_load.cc:22-68): 4 layers of conv_w and conv_b from float
    13840, the readout MLP from 321360, and the host constant ``avg_deg``."""
    f = os.path.join(model_dir, f"pna_ep1_noBN_dim{dim}.weights.all.bin")
    shapes = _pna_shapes(dim, 4)
    conv_w = np.zeros(shapes["conv_w"], np.float32)
    conv_b = np.zeros(shapes["conv_b"], np.float32)
    block = dim * 3 * 4 * dim
    for l in range(4):
        base = 13840 + (block + dim) * l
        conv_w[l] = _read(f, block, base).reshape(conv_w.shape[1:])
        conv_b[l] = _read(f, dim, base + block)
    out = {"node_embedding": _read(f, ATOM_FEATURE_TOTAL * dim).reshape(-1, dim),
           "conv_w": conv_w, "conv_b": conv_b}
    offsets = {"mlp1_w": 321360, "mlp1_b": 324560, "mlp2_w": 324600,
               "mlp2_b": 325400, "mlp3_w": 325420, "mlp3_b": 325440}
    for k, off in offsets.items():
        out[k] = _read(f, int(np.prod(shapes[k])), off).reshape(shapes[k])
    out["avg_deg"] = np.asarray(PNA_AVG_DEG, np.float32)
    return out


def synthetic_pna_params(seed: int, dim: int = 80, layers: int = 4) -> dict:
    """Seeded stand-in for the reference PNA weights, with the keys and
    shapes of ``load_pna``: every entry from N(0, 0.1²) as float32, except
    the conv tower ``conv_w`` from N(0, 0.01²), and ``avg_deg`` the
    reference constant. Each layer adds relu(tower) to h, and the ``scale``
    scaler (avg_deg / log(out_deg + 1), ~6 on molecules) multiplies a third
    of the tower, so h grows with the tower's scale: at 0.02 it doubles per
    layer and crosses the ap_fixed ±32 that seeds min / max by layer 4 on
    the full 4113-graph synthetic molhiv stream; at 0.01 it stays within
    ±8.4 there (seed 0, D=80), so the data, not the seeds, sets the
    aggregates."""
    rng = np.random.default_rng(seed)
    out = {
        k: rng.normal(0, 0.01 if k == "conv_w" else 0.1, s).astype(np.float32)
        for k, s in _pna_shapes(dim, layers).items()
    }
    out["avg_deg"] = np.asarray(PNA_AVG_DEG, np.float32)
    return out


def _gat_shapes(dim: int, heads: int, layers: int) -> dict:
    """Key → shape of a GAT parameter dict, in the loader's key order:
    projections [l][head_out][dim_out][head_in][dim_in]."""
    return {
        "proj_w": (layers, heads, dim, heads, dim),
        "skip_w": (layers, heads, dim, heads, dim),
        "a_src": (layers, heads, dim),
        "a_tgt": (layers, heads, dim),
        "pred_w": (1, dim),
        "pred_b": (1,),
    }


def load_gat(model_dir: str, dim: int = 16, heads: int = 4, layers: int = 5) -> dict:
    """GAT per-file layout (GAT/src/host_load.cc:14-98). Layer 0 projects the
    9 raw integer features ([heads][dim][1][9]); it is zero-padded into the
    uniform [L, head_out, dim_out, head_in, dim_in] arrays as the reference's
    zero-initialised host array holds it (GAT/src/host_load.cc:69-97)."""
    p = lambda name: os.path.join(model_dir, f"gat_ep1_{name}_layer{layers}.bin")
    shapes = _gat_shapes(dim, heads, layers)
    out = {"proj_w": np.zeros(shapes["proj_w"], np.float32),
           "skip_w": np.zeros(shapes["skip_w"], np.float32)}
    rest = (layers - 1) * heads * dim * heads * dim
    for key, name in (("proj_w", "linear_proj_weight"), ("skip_w", "skip_proj_weight")):
        out[key][0, :, :, 0, :9] = _read(p(f"{name}_0"), heads * dim * 9).reshape(heads, dim, 9)
        out[key][1:] = _read(p(f"{name}_1"), rest).reshape(shapes[key][0] - 1, *shapes[key][1:])
    for key, name in (("a_src", "scoring_fn_source"), ("a_tgt", "scoring_fn_target"),
                      ("pred_w", "pred_weights"), ("pred_b", "pred_bias")):
        out[key] = _read(p(name), int(np.prod(shapes[key]))).reshape(shapes[key])
    return out


def synthetic_gat_params(seed: int, dim: int = 16, heads: int = 4, layers: int = 5) -> dict:
    """Seeded stand-in for the reference GAT weights, with the keys and
    shapes of ``load_gat``: every entry from N(0, 0.1²) as float32, layer 0
    nonzero only on its 9 raw-feature inputs, as the loader pads it. Layer 0
    projects the raw integer features (atomic numbers up to 118), and the
    edge softmax is a raw ``exp`` with no max subtraction, which overflows
    float32 above 88.7: at 0.1 the largest |raw score| over the full
    4113-graph synthetic molhiv stream is 10.75 (seed 0, layer 1; 10.40 at
    layer 0), so no score comes near the overflow."""
    rng = np.random.default_rng(seed)
    out = {
        k: rng.normal(0, 0.1, s).astype(np.float32)
        for k, s in _gat_shapes(dim, heads, layers).items()
    }
    for key in ("proj_w", "skip_w"):
        first = np.zeros_like(out[key][0])
        first[:, :, 0, :9] = out[key][0, :, :, 0, :9]
        out[key][0] = first
    return out


def _dgn_shapes(dim: int, layers: int) -> dict:
    """Key → shape of a DGN parameter dict, in the loader's key order:
    posttrans [l][dim_out][channel][dim_in], channel 0 the mean aggregation
    and channel 1 the directional derivative."""
    return {
        "atom_tables": (len(ATOM_FEATURE_DIMS), max(ATOM_FEATURE_DIMS), dim),
        "posttrans_w": (layers, dim, 2, dim),
        "posttrans_b": (layers, dim),
        "mlp1_w": (50, dim),
        "mlp1_b": (50,),
        "mlp2_w": (25, 50),
        "mlp2_b": (25,),
        "mlp3_w": (1, 25),
        "mlp3_b": (1,),
    }


def load_dgn(model_dir: str, dim: int = 100) -> dict:
    """DGN fseek map into dgn_ep1_noBN_dim100.weights.all.bin
    (DGN/src/host_load.cc:5-151): the 9 per-feature atom tables back to back,
    zero-padded into the device's [9][119][dim] array; 4 layers of posttrans
    weights and biases from float 17300; the readout MLP from 97700."""
    f = os.path.join(model_dir, f"dgn_ep1_noBN_dim{dim}.weights.all.bin")
    shapes = _dgn_shapes(dim, 4)
    out = {k: np.zeros(shapes[k], np.float32)
           for k in ("atom_tables", "posttrans_w", "posttrans_b")}
    off = 0
    for i, vocab in enumerate(ATOM_FEATURE_DIMS):
        out["atom_tables"][i, :vocab] = _read(f, vocab * dim, off).reshape(vocab, dim)
        off += vocab * dim
    for l in range(4):
        base = 17300 + 20100 * l
        out["posttrans_w"][l] = _read(f, dim * 2 * dim, base).reshape(dim, 2, dim)
        out["posttrans_b"][l] = _read(f, dim, base + 20000)
    offsets = {"mlp1_w": 97700, "mlp1_b": 102700, "mlp2_w": 102750,
               "mlp2_b": 104000, "mlp3_w": 104025, "mlp3_b": 104050}
    for k, o in offsets.items():
        out[k] = _read(f, int(np.prod(shapes[k])), o).reshape(shapes[k])
    return out


def synthetic_dgn_params(seed: int, dim: int = 100, layers: int = 4) -> dict:
    """Seeded stand-in for the reference DGN weights, with the keys and
    shapes of ``load_dgn`` (atom-table rows past each feature's vocabulary
    zero, as the loader pads them): every entry from N(0, 0.1²) as float32.
    Each layer adds relu(posttrans) to h, so h grows with the posttrans
    scale; at 0.1 the largest |h| on the full 4113-graph synthetic molhiv
    stream goes 1.52, 2.46, 3.83, 5.04, 7.12 from the embedding through the
    4 layers (seed 0, D=100, f32): it grows, and does not blow up."""
    rng = np.random.default_rng(seed)
    out = {
        k: rng.normal(0, 0.1, s).astype(np.float32)
        for k, s in _dgn_shapes(dim, layers).items()
    }
    for i, vocab in enumerate(ATOM_FEATURE_DIMS):
        out["atom_tables"][i, vocab:] = 0
    return out


def params_from_numpy(params: dict, prec: Precision, device) -> dict:
    """Numpy parameter dict → tensors on ``device``: every floating array of
    ``prec.compute_dtype`` (a 0-d array, PNA's ``avg_deg``, becomes a 0-d
    tensor), integer arrays as they are.

    The counterpart of ``flowgnn_tpu.models.base.prepare_params``: a
    floating array passes through ``prec.q_np`` first, float32 in the float
    modes and snapped to the ap_fixed grid in the fixed mode, as the hosts'
    float → ap_fixed casts do (GIN/src/host_load.cc:60-98), so both
    packages compute from identical values."""

    def cvt(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return torch.as_tensor(prec.q_np(x), dtype=prec.compute_dtype, device=device)
        return torch.as_tensor(x, device=device)

    return {k: cvt(v) for k, v in params.items()}
