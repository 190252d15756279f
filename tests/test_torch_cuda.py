"""The hand-written CUDA kernels against their plain torch versions, on a
card.

These tests skip without a CUDA device. The file imports no jax, so it runs
on a machine without it: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Its operand builders also serve ``test_torch_local_layer.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_molhiv
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.bench import ablate_gat_mega, matmul_shapes
from flowgnn_tpu_torch.ops import fused_layer, local_layer, spmm

L, D, H, W = 2, 32, 64, 128
T_PNA = 8  # readout MLP-1 width of the small PNA and DGN operands
GAT_L, GAT_HEADS, GAT_D = 3, 2, 16  # the small GAT operands: 3 layers of 2 × 16


def _slot_batch(name: str, seed: int) -> dict:
    """Slot layout of 8 synthetic graphs for model ``name`` (numpy)."""
    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(8, seed=seed))
    packed = pack_graphs_aligned(graphs, window=W, node_capacity=511,
                                 edge_capacity=2048, graph_capacity=16,
                                 with_eigen=spec.needs_eigen)
    return base.as_batch(packed, blocked="local_slots", window=W)


def _operands(vn: bool, seed: int = 11) -> dict:
    """GIN operands: slot layout of 8 synthetic graphs plus seeded random
    h0 and weights, as numpy arrays."""
    batch = _slot_batch("gin-vn" if vn else "gin", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=f32(n, D), pool_gl=batch["pool_gl"],
        ee_tables=f32(L * 13, D), w1_all=f32(L * H, D), b1_all=f32(L, H),
        w2_all=f32(L * D, H), b2_all=f32(L, D),
        eps_all=(1 + f32(L, 1)).astype(np.float32), pred_w=f32(D, 1),
        window=W, slots=slots, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=base.slot_prefix_caps(batch, slots),
        vn_col=batch["vn_mask"].astype(np.float32) if vn else None,
    )


def _slot_batch_big(name: str, big: int, seed: int) -> dict:
    """Slot layout (numpy) of 6 synthetic graphs and one of ``big`` nodes
    for model ``name``, at the window ``choose_geometry`` gives: 128, 256,
    384 or 512 rows, whose row-1 clusters hold 1-4 blocks."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(
        spec, synthetic_molhiv(6, seed=seed) + [random_molecule_graph(rng, num_nodes=big)])
    window = base.choose_geometry(name, max(g.num_nodes for g in graphs))[0]
    packed = pack_graphs_aligned(graphs, window=window, node_capacity=4 * window - 1,
                                 edge_capacity=4096, graph_capacity=16)
    batch = base.as_batch(packed, blocked="local_slots", window=window)
    assert "slot_meta" in batch  # no spill: row 1 takes it
    return batch


def _slot_operands(vn: bool, big: int, seed: int = 26, d: int = D, hid: int = H) -> dict:
    """Row 1's operands on ``_slot_batch_big``'s layout at width ``d`` and
    hidden width ``hid``, seeded random h0 and weights, as numpy arrays."""
    batch = _slot_batch_big("gin-vn" if vn else "gin", big, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=f32(n, d), pool_gl=batch["pool_gl"],
        ee_tables=f32(L * 13, d), w1_all=f32(L * hid, d), b1_all=f32(L, hid),
        w2_all=f32(L * d, hid), b2_all=f32(L, d),
        eps_all=(1 + f32(L, 1)).astype(np.float32), pred_w=f32(d, 1),
        window=batch["slot_geom"].shape[0], slots=slots, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=base.slot_prefix_caps(batch, slots),
        vn_col=batch["vn_mask"].astype(np.float32) if vn else None,
    )


def _gcn_operands(seed: int = 12) -> dict:
    """GCN operands: slot layout of 8 synthetic graphs, the layout's own
    degree norms, seeded random h0 and weights, as numpy arrays."""
    batch = _slot_batch("gcn", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=f32(n, D),
        dis=(1 / np.sqrt(batch["out_deg"] + 1.0)).astype(np.float32),
        pool_gl=batch["pool_gl"], ee_tables=f32(L * 13, D),
        roots=f32(L, D), alphas=(1 + f32(L, D)).astype(np.float32), betas=f32(L, D),
        wn_all=f32((L - 1) * D, D), bn_all=f32(L - 1, D), pred_w=f32(D, 1),
        window=W, slots=slots, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def _pna_operands(seed: int = 13) -> dict:
    """PNA operands: slot layout of 8 synthetic graphs, the layout's own
    degree scalers, seeded random h0 and weights, as numpy arrays."""
    from flowgnn_tpu_torch.models.pna import MAX_INIT, MIN_INIT
    from flowgnn_tpu_torch.params.loaders import PNA_AVG_DEG

    batch = _slot_batch("pna", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    log_deg = np.log(batch["out_deg"] + 1.0)
    scale = np.where(log_deg > 0, PNA_AVG_DEG / np.where(log_deg > 0, log_deg, 1), 1.0)
    return dict(
        slot_src=batch["slot_src"], h0=f32(n, D),
        inv_deg=(1 / np.maximum(batch["in_deg"], 1)).astype(np.float32),
        t=(log_deg / PNA_AVG_DEG).astype(np.float32), scale=scale.astype(np.float32),
        w_all=f32(L * 4 * D, 3 * D), b_all=f32(L, D), pool_gl=batch["pool_gl"],
        mlp1_w=f32(D, T_PNA), window=W, slots=slots, num_layers=L,
        gmax=base.POOL_GMAX, min_init=MAX_INIT, max_init=MIN_INIT,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def _pna_slot_operands(big: int, seed: int = 27, d: int = D) -> dict:
    """Row 3's operands on ``_slot_batch_big``'s PNA layout (W = 128, 256 or
    512 for a largest graph of ``big`` nodes) at width ``d``, the layout's
    own degree scalers, seeded random h0 and weights, as numpy arrays."""
    from flowgnn_tpu_torch.models.pna import MAX_INIT, MIN_INIT
    from flowgnn_tpu_torch.params.loaders import PNA_AVG_DEG

    batch = _slot_batch_big("pna", big, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    log_deg = np.log(batch["out_deg"] + 1.0)
    scale = np.where(log_deg > 0, PNA_AVG_DEG / np.where(log_deg > 0, log_deg, 1), 1.0)
    return dict(
        slot_src=batch["slot_src"], h0=f32(n, d),
        inv_deg=(1 / np.maximum(batch["in_deg"], 1)).astype(np.float32),
        t=(log_deg / PNA_AVG_DEG).astype(np.float32), scale=scale.astype(np.float32),
        w_all=f32(L * 4 * d, 3 * d), b_all=f32(L, d), pool_gl=batch["pool_gl"],
        mlp1_w=f32(d, T_PNA), window=batch["slot_geom"].shape[0], slots=slots, num_layers=L,
        gmax=base.POOL_GMAX, min_init=MAX_INIT, max_init=MIN_INIT,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def _dgn_operands(seed: int = 14) -> dict:
    """DGN operands: slot layout of 8 synthetic graphs, the layout's own
    eigenvector terms and out-degrees, seeded random h0 and weights, as
    numpy arrays."""
    from flowgnn_tpu_torch.models.dgn import EIG_EPS

    batch = _slot_batch("dgn", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    abssum = batch["eig_abssum"]
    return dict(
        slot_src=batch["slot_src"], h0=f32(n, D),
        eig=batch["node_eigen"][:, 1].copy(),
        inv_deg=(1 / np.maximum(batch["out_deg"], 1)).astype(np.float32),
        eigw_sum=batch["eigw_sum"],
        inv_abssum=(1 / np.where(abssum == 0, EIG_EPS, abssum)).astype(np.float32),
        w_all=f32(L * 2 * D, D), b_all=f32(L, D), pool_gl=batch["pool_gl"],
        mlp1_w=f32(D, T_PNA), window=W, slots=slots, num_layers=L,
        gmax=base.POOL_GMAX, prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def _gat_score_maps(a_src: np.ndarray, a_tgt: np.ndarray) -> np.ndarray:
    """Per-layer [a_src, a_tgt] ([L, H, D] each) → the [L·HD, 2H]
    block-diagonal score maps h → [s_src ‖ s_tgt]."""
    layers, heads, d = a_src.shape
    eye = np.eye(heads, dtype=np.float32)
    amap = lambda a: (a[:, :, :, None] * eye[None, :, None, :]).reshape(layers, heads * d, heads)
    return np.concatenate([amap(a_src), amap(a_tgt)], axis=2).reshape(-1, 2 * heads)


def _gat_operands(seed: int = 15) -> dict:
    """GAT operands: slot layout of 8 synthetic graphs with self loops,
    seeded random h0, skip0 and weights, as numpy arrays."""
    batch = _slot_batch("gat", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sd=0.3: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    hd = GAT_HEADS * GAT_D
    return dict(
        slot_pstack=batch["slot_pstack"], h0=f32(n, hd), skip0=f32(n, hd),
        proj_w=f32((GAT_L - 1) * hd, hd), skip_w=f32((GAT_L - 1) * hd, hd),
        a_all=_gat_score_maps(f32(GAT_L, GAT_HEADS, GAT_D), f32(GAT_L, GAT_HEADS, GAT_D)),
        pool_gl=batch["pool_gl"], pred_hd=f32(hd, 1), window=W, slots=slots,
        num_heads=GAT_HEADS, num_layers=GAT_L, gmax=base.POOL_GMAX,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def _gat_overflow_operands(hot: bool) -> dict:
    """One window holding a ring over nodes 0..7 (slot 0) and nothing else;
    layer 0's score maps read h's first column, so s_src[v] = s_tgt[v] =
    h0[v, 0]. ``hot`` puts 100 at nodes 20 (no in-edge) and 30 (no
    out-edge): the non-edge pair (20 ← 30) scores raw 200 and every empty
    lane of row 20 raw 100, both past float32 exp's overflow at 88.7.
    Neither node reaches another's output, so the hot run must equal the
    cold one, where both are 0."""
    slots, heads, hd, layers, caps = 2, 1, 16, 2, (W, 64)
    rng = np.random.default_rng(3)
    pstack = np.full(sum(caps), W, np.int32)
    pstack[:8] = (np.arange(8) - 1) % 8
    h0 = (rng.normal(size=(W, hd)) * 0.1).astype(np.float32)
    h0[[20, 30], 0] = 100.0 if hot else 0.0
    a_first = np.zeros((1, heads, hd), np.float32)
    a_first[0, 0, 0] = 1.0
    a_next = lambda: (rng.normal(size=(layers - 1, heads, hd)) * 0.01).astype(np.float32)
    return dict(
        slot_pstack=pstack, h0=h0,
        skip0=(rng.normal(size=(W, hd)) * 0.1).astype(np.float32),
        proj_w=np.eye(hd, dtype=np.float32), skip_w=np.eye(hd, dtype=np.float32) * 0.1,
        a_all=_gat_score_maps(np.concatenate([a_first, a_next()]),
                              np.concatenate([a_first, a_next()])),
        pool_gl=np.zeros(W, np.int32),
        pred_hd=rng.normal(size=(hd, 1)).astype(np.float32),
        window=W, slots=slots, num_heads=heads, num_layers=layers,
        gmax=base.POOL_GMAX, prefix_caps=caps,
    )


# The largest graph of each ELL test bucket, one per window the port's
# geometry picks for it: 128, 256, 384 and 512 rows, i.e. clusters of 1-4
# blocks of 128 rows; the 400-node graph's rows span four blocks.
ELL_BIG = (120, 250, 380, 400)


def _ell_batch(name: str, big: int, seed: int) -> dict:
    """ELL layout (numpy) of 6 synthetic graphs and one of ``big`` nodes for
    model ``name``, at the window and block ``choose_geometry`` gives."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(
        spec, synthetic_molhiv(6, seed=seed) + [random_molecule_graph(rng, num_nodes=big)])
    window, block = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    packed = pack_graphs_aligned(graphs, window=window, node_capacity=4 * window - 1,
                                 edge_capacity=4096, graph_capacity=16)
    return base.as_batch(packed, blocked="local_ell", window=window, block=block)


def _ell_operands(name: str, big: int, seed: int = 16, d: int = D, hid: int = H) -> dict:
    """Operands of the GIN / GIN-VN (``gin_local_model``) or GCN
    (``gcn_local_model``) ELL kernel: the ELL layout of ``_ell_batch``, the
    layout's own degree norms for GCN, seeded random h0 and weights (width
    ``d``, GIN's hidden width ``hid``), as numpy arrays."""
    batch = _ell_batch(name, big, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    D, H = d, hid
    common = dict(
        ell_meta=base.ell_meta(base.to_device(batch, "cpu")).numpy(), h0=f32(n, D),
        pool_gl=batch["pool_gl"], ee_tables=f32(L * 13, D), pred_w=f32(D, 1),
        window=base.ell_geometry(batch)[0], num_layers=L, gmax=base.POOL_GMAX,
    )
    if name == "gcn":
        return dict(
            common, dis=(1 / np.sqrt(batch["out_deg"] + 1.0)).astype(np.float32),
            roots=f32(L, D), alphas=(1 + f32(L, D)).astype(np.float32), betas=f32(L, D),
            wn_all=f32((L - 1) * D, D), bn_all=f32(L - 1, D),
        )
    return dict(
        common, w1_all=f32(L * H, D), b1_all=f32(L, H), w2_all=f32(L * D, H),
        b2_all=f32(L, D), eps_all=(1 + f32(L, 1)).astype(np.float32),
        vn_col=batch["vn_mask"].astype(np.float32) if name == "gin-vn" else None,
    )


# Geometries of the per-layer ELL kernels' test buckets, by id: (the largest
# graph's nodes, the ELL block or None for ``choose_geometry``'s, k). W128
# and W512 have one edge block per window; k2 packs molhiv-shaped graphs at
# W=128 into blocks of 192 lanes, so the densest windows need two.
ELL_LAYER_GEOMETRY = {"W128": (120, None, 1), "W512": (400, None, 1), "k2": (120, 192, 2)}


def _ell_layer_batch(geometry: str, seed: int) -> dict:
    """ELL layout (numpy) of 6 synthetic graphs and one large one at a
    geometry of ``ELL_LAYER_GEOMETRY``."""
    big, block, k = ELL_LAYER_GEOMETRY[geometry]
    if block is None:
        batch = _ell_batch("gin", big, seed)
    else:
        rng = np.random.default_rng(seed)
        graphs = synthetic_molhiv(6, seed=seed) + [random_molecule_graph(rng, num_nodes=big)]
        packed = pack_graphs_aligned(graphs, window=W, node_capacity=511, edge_capacity=4096,
                                     graph_capacity=16)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the k > 1 note
            batch = base.as_batch(packed, blocked="local_ell", window=W, block=block)
    assert base.ell_geometry(batch)[1] == k
    return batch


def _ell_layer_operands(kernel: str, geometry: str, final: bool = False, seed: int = 18,
                        d: int = D, hid: int = H) -> dict:
    """Seeded operands of one per-layer ELL kernel (``gin_local_layer_ell``
    with a nonzero ``m_spill``, ``gcn_local_message_ell``,
    ``gcn_local_layer_ell``) on the layout of ``_ell_layer_batch``, the
    layout's own degree norms for GCN, as numpy arrays; ``final`` takes the
    last layer's form (no ReLU for GIN, no next conv for GCN); ``d`` and
    ``hid`` GIN's widths."""
    batch = _ell_layer_batch(geometry, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    D, H = d, hid
    ops = dict(ell_meta=base.ell_meta(base.to_device(batch, "cpu")).numpy(), h=f32(n, D),
               ee_table=f32(13, D), window=base.ell_geometry(batch)[0])
    if kernel == "gin_local_layer_ell":
        return dict(ops, m_spill=f32(n, D), w1=f32(H, D), b1=f32(H), w2=f32(D, H), b2=f32(D),
                    eps1=(1 + f32(1, 1)).astype(np.float32), final_relu=not final)
    ops["dis"] = (1 / np.sqrt(batch["out_deg"] + 1.0)).astype(np.float32)
    if kernel == "gcn_local_message_ell":
        return ops
    return dict(ops, root=f32(D), alpha=(1 + f32(D)).astype(np.float32), beta=f32(D),
                w_next=None if final else f32(D, D), b_next=None if final else f32(D))


def _dgn_gat_ell_operands(kernel: str, geometry: str, seed: int = 19) -> dict:
    """Seeded operands at full width of row 16 (``dgn_local_message_ell``,
    D=100), row 18 (``dgn_local_layer_ell``) or row 17
    (``gat_local_message_ell``, 4 heads × 16) on the layout of
    ``_ell_layer_batch``, as numpy arrays (``_dgn_ell_batch_operands``,
    ``_gat_ell_batch_operands``)."""
    batch = _ell_layer_batch(geometry, seed)
    rng = np.random.default_rng(seed)
    if kernel == "gat_local_message_ell":
        return _gat_ell_batch_operands(batch, rng, 64, 4)
    return _dgn_ell_batch_operands(batch, rng, 100, kernel == "dgn_local_layer_ell")


def _ell_lane_operands(batch: dict) -> dict:
    return dict(ell_meta=base.ell_meta(base.to_device(batch, "cpu")).numpy(),
                window=base.ell_geometry(batch)[0])


def _gat_ell_batch_operands(batch: dict, rng, hd: int, heads: int) -> dict:
    """Row 17's seeded operands (H·D = ``hd``, ``heads`` heads) on an ELL
    batch, as numpy arrays."""
    f32 = lambda *s, sd=0.5: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    return dict(_ell_lane_operands(batch), h=f32(n, hd), s_src=f32(n, heads, sd=2.0),
                s_tgt=f32(n, heads, sd=2.0), num_heads=heads)


def _dgn_ell_batch_operands(batch: dict, rng, d: int, full: bool) -> dict:
    """Row 16's (``full`` False) or row 18's seeded operands at width ``d``
    on an ELL batch, as numpy arrays. The eigenvector entries are random;
    the node terms are the layout's own sums of them over every lane (a
    zero absolute sum → 1/EIG_EPS = 8192, as the model guards it)."""
    from flowgnn_tpu_torch.models.dgn import EIG_EPS

    f32 = lambda *s, sd=0.5: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    ops = _ell_lane_operands(batch)
    eig = f32(n, sd=0.3)
    ops.update(h=f32(n, d), eig=eig)
    if not full:
        return ops
    u, v = batch["senders"], batch["receivers"]
    ew = eig[u] - eig[v]
    ews, abssum = np.zeros(n, np.float32), np.zeros(n, np.float32)
    np.add.at(ews, v, ew)
    np.add.at(abssum, v, np.abs(ew))
    return dict(
        ops, inv_deg=(1 / np.maximum(batch["out_deg"], 1)).astype(np.float32), eigw_sum=ews,
        inv_abssum=(1 / np.where(abssum == 0, EIG_EPS, abssum)).astype(np.float32),
        w_post=f32(2 * d, d, sd=0.1), b_post=f32(1, d),
    )


def _pna_layer_operands(seed: int = 20) -> dict:
    """Seeded operands of row 20 (``pna_local_layer``) at full width (D=80)
    on the slot layout of 8 synthetic graphs, with the layout's own degree
    scalers, as numpy arrays."""
    from flowgnn_tpu_torch.models.pna import MAX_INIT, MIN_INIT
    from flowgnn_tpu_torch.params.loaders import PNA_AVG_DEG

    batch = _slot_batch("pna", seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sd=0.1: rng.normal(0, sd, s).astype(np.float32)
    d = 80
    n = batch["node_feat"].shape[0]
    log_deg = np.log(batch["out_deg"] + 1.0)
    scale = np.where(log_deg > 0, PNA_AVG_DEG / np.where(log_deg > 0, log_deg, 1), 1.0)
    return dict(
        slot_src=batch["slot_src"], h=f32(n, d, sd=2.0),
        inv_deg=(1 / np.maximum(batch["in_deg"], 1)).astype(np.float32),
        t=(log_deg / PNA_AVG_DEG).astype(np.float32), scale=scale.astype(np.float32),
        w_cat=f32(4 * d, 3 * d), b=f32(1, d), window=W, slots=batch["slot_geom"].shape[-1],
        min_init=MAX_INIT, max_init=MIN_INIT,
    )


def _spill_batch(name: str, seed: int) -> dict:
    """Slot layout at W=128 (numpy) of 8 synthetic graphs and two of 230 and
    280 nodes for model ``name``: a real spill tail, in blocked order."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(8, seed=seed) + [
        random_molecule_graph(rng, num_nodes=k) for k in (230, 280)])
    packed = pack_graphs_aligned(graphs, window=W, node_capacity=1023, edge_capacity=4096,
                                 graph_capacity=16, with_eigen=spec.needs_eigen)
    return base.as_batch(packed, blocked="local_slots", window=W)


def _layer_operands(kernel: str, seed: int = 17, **kw) -> dict:
    """Seeded operands of one per-layer slot kernel on a spilling batch's
    layout, as numpy arrays: ``pna_local_stats_ell`` (D=80),
    ``dgn_local_layer_slots`` (D=100; ``spill`` adds m_spill),
    ``gat_local_message_slots`` (4 heads × 16; ``divide``) and
    ``windowed_segment_sum`` (D'=200 over the blocked spill lanes)."""
    from flowgnn_tpu_torch.models.dgn import EIG_EPS
    from flowgnn_tpu_torch.models.pna import MAX_INIT, MIN_INIT

    name = {"pna_local_stats_ell": "pna", "dgn_local_layer_slots": "dgn",
            "gat_local_message_slots": "gat", "windowed_segment_sum": "pna"}[kernel]
    batch = _spill_batch(name, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sd=0.5: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    if kernel == "windowed_segment_sum":
        vloc = batch["spill_blk_vlocal"]
        return dict(values=f32(vloc.shape[0], 200), v_local=vloc[:, None].copy(),
                    block_window=batch["spill_blk_window"], window=512,
                    num_windows=batch["spill_blk_compact"].shape[0])
    if kernel == "pna_local_stats_ell":
        return dict(slot_src=batch["slot_src"], h=f32(n, 80, sd=2.0), window=W, slots=slots,
                    min_init=MAX_INIT, max_init=MIN_INIT)
    if kernel == "dgn_local_layer_slots":
        d = 100
        abssum = batch["eig_abssum"]
        return dict(
            slot_src=batch["slot_src"], h=f32(n, d), eig=batch["node_eigen"][:, 1].copy(),
            inv_deg=(1 / np.maximum(batch["out_deg"], 1)).astype(np.float32),
            eigw_sum=batch["eigw_sum"],
            inv_abssum=(1 / np.where(abssum == 0, EIG_EPS, abssum)).astype(np.float32),
            w_post=f32(2 * d, d, sd=0.1), b_post=f32(1, d), window=W, slots=slots,
            m_spill=f32(n, 2 * d) if kw.get("spill") else None,
        )
    heads, hd = 4, 64
    return dict(slot_stack=batch["slot_stack"], h=f32(n, hd), s_src=f32(n, heads, sd=2.0),
                s_tgt=f32(n, heads, sd=2.0), window=W, slots=slots, num_heads=heads,
                divide=kw.get("divide", True))


def _gat_message_overflow_operands(hot: bool) -> dict:
    """One window with a ring over rows 0..7 in slot 0 and every other slot
    empty; ``hot`` puts raw scores of 100 (past float32 exp's 88.7) at rows 20
    and 30, which have no source and no reader: their empty slots must add
    nothing, so the hot run equals the cold one."""
    slots, heads, hd = 3, 2, 8
    rng = np.random.default_rng(2)
    stack = np.full((slots, W), W, np.int32)
    stack[0, :8] = (np.arange(8) + 1) % 8
    s = np.zeros((W, heads), np.float32)
    s[[20, 30]] = 100.0 if hot else 0.0
    return dict(slot_stack=stack.reshape(-1), h=rng.normal(size=(W, hd)).astype(np.float32),
                s_src=s, s_tgt=s.copy(), window=W, slots=slots, num_heads=heads)


def _gat_ell_overflow_operands(hot: bool) -> dict:
    """Row 17's operands over one window of W=128 rows and 16 lanes: a ring
    over rows 0..7, then a sentinel lane (v = W) from row 20, then pad lanes.
    ``hot`` puts scores of 100 at row 20, so the sentinel lane's raw score
    (its s_tgt: the TPU kernel's one-hot gives it s_src 0) passes float32
    exp's overflow at 88.7. Row 20 has no lane of its own and feeds no real
    lane: the hot run must equal the cold one."""
    heads, hd = 2, 16
    rng = np.random.default_rng(4)
    meta = np.full((16, 5), W, np.int32)
    meta[:8, 0], meta[:8, 1] = (np.arange(8) + 1) % 8, np.arange(8)
    meta[8, 0] = 20
    s = (rng.normal(size=(W, heads)) * 0.5).astype(np.float32)
    s[20] = 100.0 if hot else 0.0
    return dict(ell_meta=meta, h=rng.normal(size=(W, hd)).astype(np.float32), s_src=s,
                s_tgt=s.copy(), window=W, num_heads=heads)


def _local_batch(name: str = "gin", big=(), seed: int = 21) -> dict:
    """Legacy local layout (``blocked="local"``, numpy) of 8 synthetic graphs
    and one of each size in ``big`` for model ``name``: a graph above 128
    nodes crosses windows, so its crossing edges ride the spill tail."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(8, seed=seed) + [
        random_molecule_graph(rng, num_nodes=k) for k in big])
    packed = pack_graphs_aligned(graphs, window=W, node_capacity=1023, edge_capacity=4096,
                                 graph_capacity=16, with_eigen=spec.needs_eigen)
    return base.as_batch(packed, blocked="local")


def _edge_block_batch(name: str = "gin", seed: int = 22) -> dict:
    """Edge-block layout (``blocked=True``, numpy) of 8 synthetic graphs in
    unaligned packing: graphs straddle windows, and the trailing windows of
    the 1024-row bucket hold no edge."""
    from flowgnn_tpu_torch.core.graphs import pack_graphs

    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(8, seed=seed))
    packed = pack_graphs(graphs, node_capacity=1023, edge_capacity=2048, graph_capacity=16,
                         with_eigen=spec.needs_eigen)
    return base.as_batch(packed, blocked=True)


def _gin_blocks_operands(kernel: str, geometry: str = "W128", final: bool = False,
                         seed: int = 23) -> dict:
    """Seeded operands of ``gin_local_layer`` (row 10: the legacy local
    layout of ``_local_batch``, ``geometry`` "spill" adds a 300-node graph),
    ``gin_local_layer_ell_lanes`` (row 12: the ELL layout of
    ``_ell_layer_batch`` at ``geometry``) or ``gin_layer_fused`` (row 25: the
    edge-block layout of ``_edge_block_batch``; pad lanes carry values too,
    which the sentinel must keep out), as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    mlp = lambda: dict(w1=f32(H, D), b1=f32(H), w2=f32(D, H), b2=f32(D),
                       eps1=(1 + f32(1, 1)).astype(np.float32), final_relu=not final)
    if kernel == "gin_local_layer":
        batch = _local_batch(big=(300,) if geometry == "spill" else (), seed=seed)
        n, p = batch["node_feat"].shape[0], batch["loc_ulocal"].shape[0]
        return dict(ee=f32(p, D), u_local=batch["loc_ulocal"], v_local=batch["loc_vlocal"],
                    block_window=batch["loc_window"], h=f32(n, D), m_spill=f32(n, D), window=W,
                    **mlp())
    if kernel == "gin_local_layer_ell_lanes":
        batch = _ell_layer_batch(geometry, seed)
        n, p = batch["node_feat"].shape[0], batch["loc_ulocal"].shape[0]
        return dict(ee=f32(p, D), ell_meta=base.ell_meta(base.to_device(batch, "cpu")).numpy(),
                    h=f32(n, D), m_spill=f32(n, D), window=base.ell_geometry(batch)[0], **mlp())
    batch = _edge_block_batch(seed=seed)
    n, p = batch["node_feat"].shape[0], batch["blk_vlocal"].shape[0]
    return dict(vals=f32(p, D), v_local=batch["blk_vlocal"], block_window=batch["blk_window"],
                h=f32(n, D), window=W, **mlp())


def _gat_layer_operands(geometry: str, spill: bool = True, seed: int = 24) -> dict:
    """Seeded operands at full width (4 heads × 16) of row 23
    (``gat_local_layer_ell``) on the layout of ``_ell_layer_batch``, as numpy
    arrays; ``spill`` adds a ``spill_both`` with non-negative score sums."""
    ops = _dgn_gat_ell_operands("gat_local_message_ell", geometry, seed)
    rng = np.random.default_rng(seed + 1)
    f32 = lambda *s, sd=0.5: rng.normal(0, sd, s).astype(np.float32)
    n, hd = ops["h"].shape
    heads = ops["num_heads"]
    spill_both = None
    if spill:
        spill_both = np.concatenate([f32(n, hd), np.abs(f32(n, heads))], axis=1)
    return dict(
        ops, prev=f32(n, hd), spill_both=spill_both, w_skip=f32(hd, hd, sd=0.2),
        w_proj=f32(hd, hd, sd=0.2),
        a_mat=_gat_score_maps(f32(1, heads, hd // heads), f32(1, heads, hd // heads)),
    )


def _wide_ell_batch(name: str, window: int, seed: int) -> dict:
    """ELL layout (numpy) of 6 synthetic graphs and one that fills most of a
    ``window`` of 128 or 1024 rows, for model ``name``, at the default block
    (a W=1024 window takes k > 1 blocks of lanes)."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(6, seed=seed) + [
        random_molecule_graph(rng, num_nodes=window * 7 // 8)])
    packed = pack_graphs_aligned(graphs, window=window, node_capacity=4 * window - 1,
                                 edge_capacity=8192, graph_capacity=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the k > 1 note
        return base.as_batch(packed, blocked="local_ell", window=window)


def _width_operands(kernel: str, geometry: str, spill: bool, seed: int = 27) -> dict:
    """Seeded operands (numpy) of one case of ``_WIDTH_CASES``: ``geometry``
    is "W:AxB", the window and (D, H) for rows 10, 12 and 25 or (H·D,
    heads) for row 23, on ``_wide_ell_batch``'s lanes. Row 12 takes the ELL
    grid as it is; rows 10 and 25 the same lanes as one block a window named
    by ``block_window``; ``spill`` adds ``m_spill`` (row 23: a
    ``spill_both`` whose score sums are at least 0.5)."""
    window, widths = geometry.split(":")
    window, (a, b) = int(window), map(int, widths.split("x"))
    gat = kernel == "gat_local_layer_ell"
    batch = _wide_ell_batch("gat" if gat else "gin", window, seed)
    meta = base.ell_meta(base.to_device(batch, "cpu")).numpy()
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sd=0.2: rng.normal(0, sd, s).astype(np.float32)
    n, p = batch["node_feat"].shape[0], meta.shape[0]
    if gat:
        hd, heads = a, b
        spill_both = None
        if spill:
            spill_both = f32(n, hd + heads, sd=0.5)
            spill_both[:, hd:] = np.abs(spill_both[:, hd:]) + 0.5
        return dict(ell_meta=meta, h=f32(n, hd, sd=1.0), s_src=f32(n, heads, sd=0.5),
                    s_tgt=f32(n, heads, sd=0.5), prev=f32(n, hd, sd=0.5), spill_both=spill_both,
                    w_skip=f32(hd, hd), w_proj=f32(hd, hd),
                    a_mat=_gat_score_maps(f32(1, heads, hd // heads), f32(1, heads, hd // heads)),
                    window=window, num_heads=heads)
    d, hid = a, b
    ops = dict(h=f32(n, d), window=window, w1=f32(hid, d), b1=f32(hid), w2=f32(d, hid), b2=f32(d),
               eps1=(1 + f32(1, 1)).astype(np.float32), final_relu=True)
    m_spill = f32(n, d) if spill else None
    if kernel == "gin_local_layer_ell_lanes":
        return dict(ops, ee=f32(p, d), ell_meta=meta, m_spill=m_spill)
    ops.update(v_local=meta[:, 1].copy(), block_window=np.arange(-(-n // window), dtype=np.int32))
    if kernel == "gin_local_layer":
        return dict(ops, ee=f32(p, d), u_local=meta[:, 0].copy(), m_spill=m_spill)
    return dict(ops, vals=np.maximum(f32(p, d), 0))


def _gat_layer_overflow_operands(hot: bool) -> dict:
    """Row 23's operands over ``_gat_ell_overflow_operands``'s window: the
    sentinel lane from row 20, whose score overflows exp when ``hot``, must
    add nothing, so every row but row 20's own (whose s_src and s_tgt differ
    between the runs, and which nothing reads) equals the cold run's."""
    ops = _gat_ell_overflow_operands(hot)
    rng = np.random.default_rng(5)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    hd, heads = ops["h"].shape[1], ops["num_heads"]
    return dict(ops, prev=f32(W, hd), spill_both=None, w_skip=f32(hd, hd), w_proj=f32(hd, hd),
                a_mat=_gat_score_maps(f32(1, heads, hd // heads), f32(1, heads, hd // heads)))


def _blocked_wss_operands(width: int, seed: int = 25) -> dict:
    """Row 24's operands on the edge-block layout of ``_edge_block_batch`` at
    a model's reduction width (GAT 68, GIN / GCN 100, PNA 160, DGN 200):
    every window of 128 rows, the blocks left over parked on the last one;
    pad lanes carry values, which the sentinel must keep out."""
    batch = _edge_block_batch(seed=seed)
    rng = np.random.default_rng(seed)
    vloc = batch["blk_vlocal"]
    return dict(values=rng.normal(0, 0.5, (vloc.shape[0], width)).astype(np.float32),
                v_local=vloc[:, None].copy(), block_window=batch["blk_window"], window=W,
                num_windows=-(-batch["node_feat"].shape[0] // W))


# The GAT megakernel ablation's small operands: two windows of 128 rows (the
# last padded), 2 heads × 8, 2 layers, prefix caps (128, 64, 32).
ABL_W, ABL_NW, ABL_N = 128, 2, 250
ABL_HEADS, ABL_L, ABL_T = 2, 2, 1
ABL_CAPS = (128, 64, 32)


def _ablation_operands(seed: int = 0, positive: bool = False) -> dict:
    """Seeded numpy operands of every ablation form: random sources (a
    quarter of the lanes empty), prefix stacks with ``ABL_CAPS``, graph ids
    per row, v4's one-hot tiles and v5's expanded scores. With ``positive``
    every float operand is |N(0, sd)|: then every score, h and feat stays
    nonnegative, which ``noexp`` needs to be well conditioned (it divides by
    the sum of the raw, signed scores, which otherwise cancels towards zero
    and multiplies the f32 rounding of the glue products by up to ~1e3)."""
    w, nw, n, heads, layers = ABL_W, ABL_NW, ABL_N, ABL_HEADS, ABL_L
    hd = heads * 8
    pay = max(128, hd + heads)
    rng = np.random.default_rng(seed)
    sign = np.abs if positive else (lambda x: x)
    f = lambda *s, sd=0.5: sign(rng.normal(0, sd, s)).astype(np.float32)
    src = lambda *s: np.where(rng.random(s) < 0.75, rng.integers(0, w, s), w).astype(np.int32)
    pstack = np.full((nw, sum(ABL_CAPS)), w, np.int32)
    off = 0
    for c in ABL_CAPS:
        pstack[:, off : off + c] = src(nw, c)
        off += c
    glue_w = f((layers - 1) * hd, pay + hd + heads, sd=0.3)
    glue_w[:, hd + heads : pay] = 0
    gl = np.full(nw * w, base.POOL_GMAX, np.int32)
    gl[:n] = np.sort(rng.integers(0, 20, n))
    ops = dict(
        slot_stack=src(nw * len(ABL_CAPS) * w), slot_pstack=pstack.reshape(-1), h0=f(n, hd),
        prev0=f(n, hd), skip0=f(n, hd), s0=f(n, 2 * heads), skip_w=f(layers * hd, hd, sd=0.3),
        proj_w=f((layers - 1) * hd, hd, sd=0.3), a_next=f((layers - 1) * hd, 2 * heads, sd=0.3),
        glue_w=glue_w, pool_gl=gl, pred_hd=f(hd, ABL_T),
    )
    ops["onehot_tiles"] = ablate_gat_mega.onehot_tiles(
        torch.from_numpy(ops["slot_pstack"]), w, sum(ABL_CAPS), torch.float32).numpy()
    gx, sx = ablate_gat_mega.expand_score_operands(torch.from_numpy(glue_w),
                                                   torch.from_numpy(ops["s0"]), hd, heads)
    ops["glue_wx"], ops["s0x"] = gx.numpy(), sx.numpy()
    return ops


def _ablation_call(form: str, ops: dict) -> dict:
    """``gat_mega_ablate``'s keyword operands of ``form`` (numpy)."""
    c = dict(ops, window=ABL_W, slots=len(ABL_CAPS), num_heads=ABL_HEADS, num_layers=ABL_L,
             gmax=base.POOL_GMAX, prefix_caps=ABL_CAPS, caps_v4=ABL_CAPS)
    return ablate_gat_mega.form_operands(form, c)


def _port(ops: dict, device, dtype=torch.float32) -> dict:
    out = {}
    for k, v in ops.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v).to(device)
            out[k] = t.to(dtype) if t.is_floating_point() and k not in ("eps_all", "eps1") else t
        else:
            out[k] = v
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True], ids=["gin", "gin-vn"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_slots_cuda_kernel_matches_plain(vn, dtype, tol, cuda_device):
    """f32: the kernel and the plain version differ in summation order only;
    bf16: a rounding flip at one stage propagates through later layers."""
    ops = _port(_operands(vn), cuda_device, dtype)
    before = local_layer.gin_local_model_slots.launches
    got = local_layer.gin_local_model_slots(**ops)
    torch.cuda.synchronize()
    assert local_layer.gin_local_model_slots.launches == before + 1
    expect = local_layer.gin_local_model_slots_ref(**ops)
    torch.testing.assert_close(got, expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_slots_cuda_kernel_rejects_oversized_window(cuda_device):
    """A window past what row 1's clusters span (8 blocks of 128 rows, W up
    to 1024) raises before launch instead of failing inside the kernel."""
    d = 100
    n, window = 1152, 1152
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    ops = dict(
        slot_meta=torch.full((window, 4), -1, dtype=torch.int32, device=cuda_device),
        h0=t(n, d), pool_gl=torch.zeros(window, dtype=torch.int32, device=cuda_device),
        ee_tables=t(L * 13, d), w1_all=t(L * 2 * d, d), b1_all=t(L, 2 * d),
        w2_all=t(L * d, 2 * d), b2_all=t(L, d), eps_all=t(L, 1), pred_w=t(d, 1),
        window=window, slots=1, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=(window,),
    )
    before = local_layer.gin_local_model_slots.launches
    with pytest.raises(ValueError, match="whole blocks of 128 rows"):
        local_layer.gin_local_model_slots(**ops)
    assert local_layer.gin_local_model_slots.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,operands", [
    ("gcn_local_model_slots", _gcn_operands), ("pna_local_model", _pna_operands),
    ("dgn_local_model", _dgn_operands), ("gat_local_model_slots", _gat_operands),
], ids=["gcn", "pna", "dgn", "gat"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gcn_pna_cuda_kernels_match_plain(kernel, operands, dtype, tol, cuda_device):
    """f32: the kernel and the plain version differ in summation order only;
    bf16: a rounding flip at one stage propagates through later layers."""
    ops = _port(operands(), cuda_device, dtype)
    fn = getattr(local_layer, kernel)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert expect.abs().max() > 1e-2  # the pool is not trivially zero
    torch.testing.assert_close(got, expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gcn_pna_cuda_kernels_reject_oversized_window(cuda_device):
    """W=1152 is past what the clusters of rows 2 and 3 span (8 blocks of
    128 rows, W up to 1024), at GCN's published width (D=100) and PNA's
    (D=80): both wrappers raise before launch."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    i32 = lambda *s, fill=0: torch.full(s, fill, dtype=torch.int32, device=cuda_device)
    window, d = 1152, 100
    gcn = dict(
        slot_meta=i32(window, 4, fill=-1), h0=t(window, d), dis=t(window), pool_gl=i32(window),
        ee_tables=t(L * 13, d), roots=t(L, d), alphas=t(L, d), betas=t(L, d),
        wn_all=t((L - 1) * d, d), bn_all=t(L - 1, d), pred_w=t(d, 1),
        window=window, slots=1, num_layers=L, gmax=base.POOL_GMAX, prefix_caps=(window,),
    )
    window, d = 1152, 80
    pna = dict(
        slot_src=i32(window, 1, fill=window), h0=t(window, d), inv_deg=t(window),
        t=t(window), scale=t(window), w_all=t(L * 4 * d, 3 * d), b_all=t(L, d),
        pool_gl=i32(window), mlp1_w=t(d, 40), window=window, slots=1, num_layers=L,
        gmax=base.POOL_GMAX, min_init=32.0, max_init=-32.0, prefix_caps=(window,),
    )
    for kernel, ops in (("gcn_local_model_slots", gcn), ("pna_local_model", pna)):
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match="whole blocks of 128 rows"):
            fn(**ops)
        assert fn.launches == before


# Row 3 at every window its clusters take (the largest graph 120, 250 and
# 400 nodes: clusters of 1, 2 and 4 blocks), at the small width and PNA's.
PNA_BIG = (120, 250, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("big", PNA_BIG, ids=[f"W{w}" for w in (128, 256, 512)])
@pytest.mark.parametrize("d", [D, 80], ids=["D32", "D80"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_pna_cuda_kernel_windows_match_plain(big, d, dtype, tol, cuda_device):
    """Row 3 at W=128, 256 and 512 (one cluster of W/128 blocks per window,
    the large graph's sources read across all of them): bf16 through the
    wgmma tower with a weight ring of at least two chunks, f32 through the
    FMA tower; tolerances as in ``test_ell_cuda_kernels_match_plain``."""
    ops = _port(_pna_slot_operands(big, d=d), cuda_device, dtype)
    before = local_layer.pna_local_model.launches
    got = local_layer.pna_local_model(**ops)
    torch.cuda.synchronize()
    assert local_layer.pna_local_model.launches == before + 1
    stages = local_layer.pna_local_model.stages
    assert stages >= 2 if dtype == torch.bfloat16 else stages == 0
    expect = local_layer.pna_local_model_ref(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("big", ELL_BIG, ids=[f"W{w}" for w in (128, 256, 384, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gcn_ell_cuda_kernel_full_width_matches_plain(big, dtype, tol, cuda_device):
    """Row 9 at GCN's width (D=100, the bf16 next conv 104 wide in 4 weight
    chunks a layer) at every window: bf16 through the wgmma conv, its ring
    as deep as two blocks an SM allow, f32 through the FMA conv; tolerances
    as in ``test_ell_cuda_kernels_match_plain``."""
    ops = _port(_ell_operands("gcn", big, d=100), cuda_device, dtype)
    got = local_layer.gcn_local_model(**ops)
    torch.cuda.synchronize()
    stages = local_layer.gcn_local_model.stages
    assert stages == (4 if dtype == torch.bfloat16 else 0)
    expect = local_layer.gcn_local_model_ref(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy("gcn_local_model", dtype, ops["window"], (100, 13), base.POOL_GMAX, 1,
                                cuda_device)
    assert occ["blocks_per_sm"] == (2 if dtype == torch.bfloat16 else 1) and occ["clusters"] > 0


@pytest.mark.cuda
def test_rows_3_9_cuda_kernels_reject_widths_outside_their_plan(cuda_device):
    """Widths the kernels' tiles do not take raise before launch in both
    dtypes: row 9 at D = 120 (past 112) and at an odd D (its messages read
    column pairs), row 3 at D = 96 (past the tower's 80-column pitch)."""
    cases = [("gcn_local_model", _ell_operands("gcn", 120, d=120), "tile"),
             ("gcn_local_model", _ell_operands("gcn", 120, d=99), "even"),
             ("pna_local_model", _pna_slot_operands(120, d=96), "tile")]
    for kernel, ops, match in cases:
        fn = getattr(local_layer, kernel)
        before = fn.launches
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match=match):
                fn(**_port(ops, cuda_device, dtype))
        assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gcn_local_model", "pna_local_model"], ids=["row9", "row3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_3_9_knockouts_launch(kernel, dtype, cuda_device):
    """The phase split's knockouts (bit 0: the product, bit 1: the messages
    or stats) launch and leave a finite output; the whole kernel is
    unchanged by having run them. On a CPU tensor a knockout raises."""
    ops = (_ell_operands("gcn", 400, d=100) if kernel == "gcn_local_model"
           else _pna_slot_operands(400, d=80))
    ops = _port(ops, cuda_device, dtype)
    fn = getattr(local_layer, kernel)
    full = fn(**ops)
    for knockout in (1, 2, 3):
        assert bool(fn(**ops, knockout=knockout).isfinite().all())
    torch.cuda.synchronize()
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=1)


@pytest.mark.cuda
def test_dgn_gat_cuda_kernels_reject_oversized_window(cuda_device):
    """W=1152 is past what the clusters of rows 4 and 5 span (8 blocks of
    128 rows, W up to 1024), at the published widths (DGN D=100, GAT 4 × 16
    with 7 full slots): both wrappers raise before launch."""
    window, n = 1152, 1152
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    i32 = lambda *s, fill=0: torch.full(s, fill, dtype=torch.int32, device=cuda_device)
    d = 100
    dgn = dict(
        slot_src=i32(window, 1, fill=window), h0=t(n, d), eig=t(n), inv_deg=t(n),
        eigw_sum=t(n), inv_abssum=t(n), w_all=t(L * 2 * d, d), b_all=t(L, d),
        pool_gl=i32(window), mlp1_w=t(d, 50), window=window, slots=1, num_layers=L,
        gmax=base.POOL_GMAX, prefix_caps=(window,),
    )
    hd, heads, slots = 64, 4, 7
    gat = dict(
        slot_pstack=i32(slots * window, fill=window), h0=t(n, hd), skip0=t(n, hd),
        proj_w=t((L - 1) * hd, hd), skip_w=t((L - 1) * hd, hd), a_all=t(L * hd, 2 * heads),
        pool_gl=i32(window), pred_hd=t(hd, 1), window=window, slots=slots,
        num_heads=heads, num_layers=L, gmax=base.POOL_GMAX, prefix_caps=(window,) * slots,
    )
    for kernel, ops in (("dgn_local_model", dgn), ("gat_local_model_slots", gat)):
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match="whole blocks of 128 rows"):
            fn(**ops)
        assert fn.launches == before


@pytest.mark.cuda
def test_gat_cuda_kernel_overflowing_non_edge_stays_finite(cuda_device):
    """A non-edge pair whose raw score overflows exp contributes nothing:
    the kernel's output is finite and equals the benign run's."""
    hot = local_layer.gat_local_model_slots(**_port(_gat_overflow_operands(True), cuda_device))
    cold = local_layer.gat_local_model_slots(**_port(_gat_overflow_operands(False), cuda_device))
    torch.cuda.synchronize()
    assert bool(hot.isfinite().all())
    torch.testing.assert_close(hot, cold, rtol=1e-6, atol=1e-6)


# Rows 2, 4 and 5 at every window their clusters take: (the largest graph's
# nodes, the window), clusters of 1, 2, 4 and 8 blocks of 128 rows.
CLUSTER_WINDOWS = ((120, 128), (250, 256), (400, 512), (900, 1024))
CLUSTER_KERNELS = {"gcn": "gcn_local_model_slots", "dgn": "dgn_local_model",
                   "gat": "gat_local_model_slots"}
# Each kernel's occupancy geometry at the models' published widths.
CLUSTER_GEOMETRY = {"gcn": (100, 13), "dgn": (100,), "gat": (64, 4)}


def _slot_batch_at(name: str, big: int, window: int, seed: int) -> dict:
    """Slot layout (numpy) of 6 synthetic graphs and one of ``big`` nodes
    for model ``name`` at ``window``, with no spill tail."""
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(
        spec, synthetic_molhiv(6, seed=seed) + [random_molecule_graph(rng, num_nodes=big)])
    packed = pack_graphs_aligned(graphs, window=window, node_capacity=4 * window - 1,
                                 edge_capacity=8192, graph_capacity=16,
                                 with_eigen=spec.needs_eigen)
    batch = base.as_batch(packed, blocked="local_slots", window=window)
    assert "slot_meta" in batch and batch["slot_geom"].shape[0] == window  # no spill
    return batch


def _model_slot_operands(name: str, big: int, window: int, dtype, device, seed: int = 31) -> dict:
    """The whole-model slot kernel's operands as the model's forward hands
    them over (``slot_kernel_operands``: the layout's own degree and
    eigenvector terms, the bf16 weight chunks), at the published widths with
    seeded synthetic weights, on ``device``."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import dgn, gat, gcn
    from flowgnn_tpu_torch.params import loaders

    prec = BF16 if dtype == torch.bfloat16 else FLOAT32
    make = {"gcn": loaders.synthetic_gcn_params, "dgn": loaders.synthetic_dgn_params,
            "gat": loaders.synthetic_gat_params}[name]
    params = loaders.params_from_numpy(make(seed), prec, device)
    batch = base.to_device(_slot_batch_at(name, big, window, seed), device)
    model = {"gcn": gcn, "dgn": dgn, "gat": gat}[name]
    return model.slot_kernel_operands(params, batch, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLUSTER_KERNELS), ids=["row2", "row4", "row5"])
@pytest.mark.parametrize("big,window", CLUSTER_WINDOWS,
                         ids=[f"W{w}" for _, w in CLUSTER_WINDOWS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_rows_2_4_5_cuda_kernels_windows_match_plain(name, big, window, dtype, tol, cuda_device):
    """Rows 2 (GCN), 4 (DGN) and 5 (GAT) at W = 128, 256, 512 and 1024 (one
    cluster of W/128 blocks per window, the large graph's sources read
    across all of them), at the models' published widths: bf16 through the
    wgmma product with a weight ring of at least two chunks and two blocks
    an SM, f32 through FMA; tolerances as in
    ``test_ell_cuda_kernels_match_plain``, of the output's scale (the pools
    of a graph that spans blocks sum in another order)."""
    kernel = CLUSTER_KERNELS[name]
    fn = getattr(local_layer, kernel)
    ops = _model_slot_operands(name, big, window, dtype, cuda_device)
    assert ops["window"] == window
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.stages >= 2 if dtype == torch.bfloat16 else fn.stages == 0
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy(kernel, dtype, window, CLUSTER_GEOMETRY[name], base.POOL_GMAX,
                                ops["pred_w" if name == "gcn" else "mlp1_w" if name == "dgn"
                                    else "pred_hd"].shape[1], cuda_device)
    assert occ["blocks_per_sm"] == (2 if dtype == torch.bfloat16 else 1) and occ["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLUSTER_KERNELS), ids=["row2", "row4", "row5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_2_4_5_knockouts_launch(name, dtype, cuda_device):
    """The phase split's knockouts of rows 2, 4 and 5 (bit 0: the product,
    bit 1: the messages or channels) launch at W=512 and leave a finite
    output; the whole kernel is unchanged by having run them. On a CPU
    tensor a knockout raises."""
    fn = getattr(local_layer, CLUSTER_KERNELS[name])
    ops = _model_slot_operands(name, 400, 512, dtype, cuda_device)
    full = fn(**ops)
    for knockout in (1, 2, 3):
        assert bool(fn(**ops, knockout=knockout).isfinite().all())
    torch.cuda.synchronize()
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=1)


# Rows 20 and 22, the one-layer forms of rows 3 and 4: the case's model, the
# wrapper, and whether the layer takes a seeded m_spill (row 22 only).
LAYER_ROWS = [("pna", "pna_local_layer", False), ("dgn", "dgn_local_layer_slots", False),
              ("dgn", "dgn_local_layer_slots", True)]
LAYER_ROW_IDS = ["row20", "row22", "row22-spill"]


def _model_layer_operands(name: str, big: int, window: int, dtype, device, spill: bool = False,
                          seed: int = 32) -> dict:
    """Layer 0's operands of row 20 or 22 as the model's per-layer slot path
    hands them over (``layer_kernel_operands``: the layout's own degree and
    eigenvector terms, layer 0's slice of the bf16 chunks), at the published
    widths (PNA D=80, DGN D=100) with seeded synthetic weights, on
    ``device``; ``spill`` adds a seeded m_spill [n, 2D]."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import dgn, pna
    from flowgnn_tpu_torch.params import loaders

    prec = BF16 if dtype == torch.bfloat16 else FLOAT32
    make = {"pna": loaders.synthetic_pna_params, "dgn": loaders.synthetic_dgn_params}[name]
    params = loaders.params_from_numpy(make(seed), prec, device)
    batch = base.to_device(_slot_batch_at(name, big, window, seed), device)
    kernel = {"pna": "pna_local_layer", "dgn": "dgn_local_layer_slots"}[name]
    ops = {"pna": pna, "dgn": dgn}[name].layer_kernel_operands(params, batch, prec)[kernel]
    if spill:
        rng = np.random.default_rng(seed)
        n, d = ops["h"].shape
        ops["m_spill"] = torch.from_numpy(
            rng.normal(0, 0.5, (n, 2 * d)).astype(np.float32)).to(device, dtype)
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,spill", LAYER_ROWS, ids=LAYER_ROW_IDS)
@pytest.mark.parametrize("big,window", CLUSTER_WINDOWS,
                         ids=[f"W{w}" for _, w in CLUSTER_WINDOWS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_rows_20_22_cuda_kernels_windows_match_plain(name, kernel, spill, big, window, dtype, tol,
                                                      cuda_device):
    """Rows 20 (PNA) and 22 (DGN, with and without m_spill) at W = 128, 256,
    512 and 1024 (one cluster of W/128 blocks per window, the large graph's
    sources read across all of them), at the published widths, one launch
    per call: bf16 through the wgmma product with a weight ring of at least
    two chunks (row 22 two blocks an SM, row 20 one), f32 through FMA.
    f32: summation order only; bf16: the output rounds to bf16, and a
    rounding flip of a stat or a channel moves it by a few bf16 ulps of its
    scale."""
    fn = getattr(local_layer, kernel)
    ops = _model_layer_operands(name, big, window, dtype, cuda_device, spill)
    assert ops["window"] == window
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.stages >= 2 if dtype == torch.bfloat16 else fn.stages == 0
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    lib = {"pna": "pna_local_layer_slots", "dgn": "dgn_local_layer_slots"}[name]
    occ = local_layer.occupancy(lib, dtype, window, (ops["h"].shape[1],), 0, 0, cuda_device)
    two = dtype == torch.bfloat16 and name == "dgn"
    assert occ["blocks_per_sm"] == (2 if two else 1) and occ["clusters"] > 0


@pytest.mark.cuda
def test_rows_20_22_cuda_kernels_reject_oversized_window(cuda_device):
    """W=1152 is past what the clusters of rows 20 and 22 span (8 blocks of
    128 rows, W up to 1024), at the published widths (PNA D=80, DGN D=100),
    in both dtypes: both wrappers raise before launch."""
    window = n = 1152
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(
            cuda_device, dtype)
        src = torch.full((window, 1), window, dtype=torch.int32, device=cuda_device)
        d = 80
        pna = dict(slot_src=src, h=t(n, d), inv_deg=t(n), t=t(n), scale=t(n),
                   w_cat=t(4 * d, 3 * d), b=t(1, d), window=window, slots=1,
                   min_init=32.0, max_init=-32.0)
        d = 100
        dgn = dict(slot_src=src, h=t(n, d), eig=t(n), inv_deg=t(n), eigw_sum=t(n),
                   inv_abssum=t(n), w_post=t(2 * d, d), b_post=t(1, d), window=window, slots=1,
                   m_spill=t(n, 2 * d))
        for kernel, ops in (("pna_local_layer", pna), ("dgn_local_layer_slots", dgn)):
            fn = getattr(local_layer, kernel)
            before = fn.launches
            with pytest.raises(ValueError, match="whole blocks of 128 rows"):
                fn(**ops)
            assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,spill", LAYER_ROWS, ids=LAYER_ROW_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_20_22_knockouts_launch(name, kernel, spill, dtype, cuda_device):
    """The phase split's knockouts of rows 20 and 22 (bit 0: the product,
    bit 1: the stats or channels) launch at W=512 and leave a finite
    output; the whole kernel is unchanged by having run them. On a CPU
    tensor a knockout raises."""
    fn = getattr(local_layer, kernel)
    ops = _model_layer_operands(name, 400, 512, dtype, cuda_device, spill)
    full = fn(**ops)
    for knockout in (1, 2, 3):
        assert bool(fn(**ops, knockout=knockout).isfinite().all())
    torch.cuda.synchronize()
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn"])
@pytest.mark.parametrize("big", ELL_BIG, ids=[f"W{w}" for w in (128, 256, 384, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_ell_cuda_kernels_match_plain(name, big, dtype, tol, cuda_device):
    """Each ELL kernel against its plain version at every window the
    geometry gives graphs of up to 400 nodes, the largest graph's rows
    spanning all the blocks of its window's cluster. f32: summation order
    only (the cross-block pools among it); bf16: a rounding flip at one
    stage propagates through later layers."""
    kernel = "gcn_local_model" if name == "gcn" else "gin_local_model"
    ops = _port(_ell_operands(name, big), cuda_device, dtype)
    fn = getattr(local_layer, kernel)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert expect.abs().max() > 1e-2  # the pool is not trivially zero
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)


# Row 8's bf16 form runs its MLP on wgmma: widths whose D and H are not
# multiples of 16 (D' = 48, H' = 96, N2 = 104) beside the models' own
# (D' = 112, H' = 224, N2 = 104).
GIN_WIDTHS = [(36, 72), (100, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("big", ELL_BIG, ids=[f"W{w}" for w in (128, 256, 384, 512)])
@pytest.mark.parametrize("d,hid", GIN_WIDTHS, ids=[f"D{d}-H{h}" for d, h in GIN_WIDTHS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gin_ell_cuda_kernel_widths_match_plain(name, big, d, hid, dtype, tol, cuda_device):
    """Row 8 at every window and at two widths: bf16 through the wgmma
    MLP (padded K, hidden chunks and output tile), f32 through the FMA MLP;
    tolerances as in ``test_ell_cuda_kernels_match_plain``."""
    ops = _port(_ell_operands(name, big, d=d, hid=hid), cuda_device, dtype)
    before = local_layer.gin_local_model.launches
    got = local_layer.gin_local_model(**ops)
    torch.cuda.synchronize()
    assert local_layer.gin_local_model.launches == before + 1
    expect = local_layer.gin_local_model_ref(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gin_ell_cuda_kernel_rejects_bf16_outside_wgmma_plan(cuda_device):
    """bf16 past the wgmma MLP's plan raises before launch, as the f32 FMA
    form does: D = 120 (past the K tile of 112). H = 512, whose 16 weight
    chunks do not fit shared memory at once, runs in both forms, bf16
    through a ring of fewer buffers than chunks, and matches the plain
    version (f32 1e-4, bf16 5e-2)."""
    before = local_layer.gin_local_model.launches
    for dtype in (torch.bfloat16, torch.float32):
        ops = _port(_ell_operands("gin", 120, d=120, hid=64), cuda_device, dtype)
        with pytest.raises(ValueError, match="tile"):
            local_layer.gin_local_model(**ops)
    assert local_layer.gin_local_model.launches == before
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        ops = _port(_ell_operands("gin", 120, d=100, hid=512), cuda_device, dtype)
        got = local_layer.gin_local_model(**ops)
        torch.cuda.synchronize()
        assert local_layer.gin_local_model.stages == (0 if dtype == torch.float32 else 8)
        expect = local_layer.gin_local_model_ref(**ops)
        scale = max(1.0, expect.abs().max().item())
        torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)
    assert local_layer.gin_local_model.launches == before + 2


# Row 1 at every window its clusters take beside W=128 (the largest graph
# 120, 250 and 400 nodes: clusters of 1, 2 and 4 blocks).
SLOT_BIG = (120, 250, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True], ids=["gin", "gin-vn"])
@pytest.mark.parametrize("big", SLOT_BIG, ids=[f"W{w}" for w in (128, 256, 512)])
@pytest.mark.parametrize("d,hid", GIN_WIDTHS, ids=[f"D{d}-H{h}" for d, h in GIN_WIDTHS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_slots_cuda_kernel_windows_match_plain(vn, big, d, hid, dtype, tol, cuda_device):
    """Row 1 at W=128, 256 and 512 (one cluster of W/128 blocks per window,
    the large graph's rows across all of them) and at two widths: bf16
    through the wgmma MLP with its weight ring all of a layer's chunks deep,
    f32 through the FMA MLP; tolerances as in
    ``test_ell_cuda_kernels_match_plain``."""
    ops = _port(_slot_operands(vn, big, d=d, hid=hid), cuda_device, dtype)
    before = local_layer.gin_local_model_slots.launches
    got = local_layer.gin_local_model_slots(**ops)
    torch.cuda.synchronize()
    assert local_layer.gin_local_model_slots.launches == before + 1
    chunks = local_layer.gin_mlp_geometry(d, hid)[3]
    assert local_layer.gin_local_model_slots.stages == (chunks if dtype == torch.bfloat16 else 0)
    expect = local_layer.gin_local_model_slots_ref(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gin_local_model_slots", "gin_local_model",
                                    "gin_local_layer_ell"], ids=["row1", "row8", "row13"])
@pytest.mark.parametrize("d,hid", [(100, 200), (100, 512)], ids=["H200", "H512"])
def test_gin_bf16_kernels_stream_weights_at_any_hidden_width(kernel, d, hid, cuda_device):
    """Rows 1, 8 and 13 in bf16 at D = 100 with H = 200 (7 weight chunks a
    layer) and H = 512 (16): the ring's depth is chosen by shape (rows 1
    and 8 all 7 chunks or the 8 that fit beside their windows; row 13 the 5
    that keep two blocks an SM) and the result matches the plain version at
    5e-2 of its scale."""
    if kernel == "gin_local_model_slots":
        ops = _slot_operands(True, 400, d=d, hid=hid)
    elif kernel == "gin_local_model":
        ops = _ell_operands("gin-vn", 400, d=d, hid=hid)
    else:
        ops = _ell_layer_operands(kernel, "W512", d=d, hid=hid)
    ops = _port(ops, cuda_device, torch.bfloat16)
    fn = getattr(local_layer, kernel)
    got = fn(**ops)
    torch.cuda.synchronize()
    chunks = local_layer.gin_mlp_geometry(d, hid)[3]
    assert fn.stages == (5 if kernel == "gin_local_layer_ell" else min(chunks, 8))
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=5e-2, atol=5e-2)


_LAYER_CASES = [
    ("windowed_segment_sum", {}), ("pna_local_stats_ell", {}),
    ("dgn_local_layer_slots", {}), ("dgn_local_layer_slots", {"spill": True}),
    ("gat_local_message_slots", {"divide": True}), ("gat_local_message_slots", {"divide": False}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kw", _LAYER_CASES,
                         ids=["row24", "row19", "row22", "row22-spill", "row21-divide", "row21-sums"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_layer_cuda_kernels_match_plain(kernel, kw, dtype, tol, cuda_device):
    """Kernel table rows 24, 19, 22 and 21 against their plain versions on a
    spilling batch's layout at full width. f32: summation order only; bf16:
    the output rounds to bf16 (a rounding flip is one bf16 ulp of the
    output, within 5e-2 of its scale)."""
    fn = getattr(spmm if kernel == "windowed_segment_sum" else local_layer, kernel)
    ops = _port(_layer_operands(kernel, **kw), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = getattr(spmm if kernel == "windowed_segment_sum" else local_layer, f"{kernel}_ref")(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gat_message_cuda_kernel_overflowing_empty_slot_stays_finite(cuda_device):
    """Row 21 on the card: empty slots whose score overflows exp add
    nothing; the output is finite and equals the benign run's."""
    for divide in (True, False):
        outs = [
            local_layer.gat_local_message_slots(
                **_port(_gat_message_overflow_operands(hot), cuda_device), divide=divide)
            for hot in (False, True)
        ]
        torch.cuda.synchronize()
        assert bool(outs[1].isfinite().all())
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


_ELL_LAYER_CASES = [
    ("gin_local_layer_ell", False), ("gin_local_layer_ell", True),
    ("gcn_local_message_ell", False), ("gcn_local_layer_ell", False),
    ("gcn_local_layer_ell", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,final", _ELL_LAYER_CASES,
                         ids=["row13", "row13-final", "row14", "row15", "row15-final"])
@pytest.mark.parametrize("geometry", list(ELL_LAYER_GEOMETRY))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_ell_layer_cuda_kernels_match_plain(kernel, final, geometry, dtype, tol, cuda_device):
    """Kernel table rows 13, 14 and 15 against their plain versions at W=128,
    at W=512 (four blocks per window) and at k=2, one launch per call. f32:
    summation order only; bf16: the output rounds to bf16, and a rounding
    flip of act or z moves it by a few bf16 ulps of its scale."""
    fn = getattr(local_layer, kernel)
    ops = _port(_ell_layer_operands(kernel, geometry, final), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [192, 1152])
def test_ell_layer_cuda_kernels_reject_window(window, cuda_device):
    """A window that is not whole 128-row tiles (192) or spans more than 8
    of them (1152) raises before launch, for each per-layer ELL kernel."""
    ops = _port(_ell_layer_operands("gin_local_layer_ell", "W128"), cuda_device)
    n = -(-ops["h"].shape[0] // window) * window
    lanes = torch.full((n // window * 8, 5), window, dtype=torch.int32, device=cuda_device)
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    common = dict(ell_meta=lanes, h=t(n, D), ee_table=t(13, D), window=window)
    cases = {
        "gin_local_layer_ell": dict(common, m_spill=None, w1=ops["w1"], b1=ops["b1"], w2=ops["w2"],
                                    b2=ops["b2"], eps1=ops["eps1"], final_relu=True),
        "gcn_local_message_ell": dict(common, dis=t(n)),
        "gcn_local_layer_ell": dict(common, dis=t(n), root=t(D), alpha=t(D), beta=t(D),
                                    w_next=t(D, D), b_next=t(D)),
    }
    for kernel, kw in cases.items():
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match="whole blocks"):
            fn(**kw)
        assert fn.launches == before


_NEW_LAYER_CASES = [
    ("pna_local_layer", "W128"), *(
        (k, g) for k in ("dgn_local_message_ell", "dgn_local_layer_ell", "gat_local_message_ell")
        for g in ELL_LAYER_GEOMETRY),
]


def _new_layer_operands(kernel: str, geometry: str) -> dict:
    return (_pna_layer_operands() if kernel == "pna_local_layer"
            else _dgn_gat_ell_operands(kernel, geometry))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,geometry", _NEW_LAYER_CASES,
                         ids=[f"{k}-{g}" for k, g in _NEW_LAYER_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_rows_16_to_20_cuda_kernels_match_plain(kernel, geometry, dtype, tol, cuda_device):
    """Kernel table rows 20 (slot layout, W=128), 16, 18 and 17 (ELL at
    W=128, at W=512, four blocks per window, and at k=2) against their plain
    versions at full width, one launch per call. f32: summation order only;
    bf16: the output rounds to bf16, and a rounding flip of a stat, a
    channel or a lane's product moves it by a few bf16 ulps of its scale."""
    fn = getattr(local_layer, kernel)
    ops = _port(_new_layer_operands(kernel, geometry), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = getattr(local_layer, f"{kernel}_ref")(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_rows_16_to_20_cuda_kernels_reject_geometry(cuda_device):
    """Each new wrapper raises before launch on what its kernel cannot take:
    rows 16, 17 and 18 a window that is not whole 128-row tiles (192) or
    spans more than 8 (1152), row 18 a D past its tile (128 > 112), row 17
    more than 32 heads; row 20 a window past its clusters (W=1152 at D=80:
    W=512, which its one-block form refused, runs on a cluster of four)."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    cases = []
    for window in (192, 1152):
        n = 2 * window
        lanes = torch.full((2 * 8, 5), window, dtype=torch.int32, device=cuda_device)
        common = dict(ell_meta=lanes, window=window)
        cases += [
            ("dgn_local_message_ell", dict(common, h=t(n, 100), eig=t(n)), "whole blocks"),
            ("dgn_local_layer_ell", dict(common, h=t(n, 100), eig=t(n), inv_deg=t(n),
                                         eigw_sum=t(n), inv_abssum=t(n), w_post=t(200, 100),
                                         b_post=t(1, 100)), "whole blocks"),
            ("gat_local_message_ell", dict(common, h=t(n, 64), s_src=t(n, 4), s_tgt=t(n, 4),
                                           num_heads=4), "whole blocks"),
        ]
    n, d = 256, 128
    lanes = torch.full((2 * 8, 5), 128, dtype=torch.int32, device=cuda_device)
    cases += [
        ("dgn_local_layer_ell", dict(ell_meta=lanes, window=128, h=t(n, d), eig=t(n),
                                     inv_deg=t(n), eigw_sum=t(n), inv_abssum=t(n),
                                     w_post=t(2 * d, d), b_post=t(1, d)), "tile"),
        ("gat_local_message_ell", dict(ell_meta=lanes, window=128, h=t(n, 128), s_src=t(n, 64),
                                       s_tgt=t(n, 64), num_heads=64), "num_heads"),
        ("pna_local_layer", dict(
            slot_src=torch.full((1152, 1), 1152, dtype=torch.int32, device=cuda_device),
            h=t(1152, 80), inv_deg=t(1152), t=t(1152), scale=t(1152), w_cat=t(320, 240),
            b=t(1, 80), window=1152, slots=1, min_init=32.0, max_init=-32.0), "whole blocks"),
    ]
    for kernel, kw, match in cases:
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(**kw)
        assert fn.launches == before


# Row 18's buckets (one cluster of W/128 blocks a window): by window, the
# large graph's nodes and the ELL blocks that give k = 1 and k = 2 edge
# blocks a window with no spill tail.
ROW18_GEOMETRY = {128: (120, 512, 192), 256: (250, 1024, 384), 512: (400, 2048, 768),
                  1024: (900, 2048, 1280)}


def _ell_window_batch(name: str, window: int, k: int, seed: int) -> dict:
    """ELL layout (numpy) of 6 synthetic graphs and one of ``ROW18_GEOMETRY``'s
    large ones for model ``name`` at ``window``, k edge blocks a window, no
    spill tail (GAT, whose self loops add a lane a row: k = 1, blocks of 4W
    lanes)."""
    big, block1, block2 = ROW18_GEOMETRY[window]
    if name == "gat":
        block1 = 4 * window
    spec = registry.get(name)
    rng = np.random.default_rng(seed)
    graphs = registry.apply_transforms(
        spec, synthetic_molhiv(6, seed=seed) + [random_molecule_graph(rng, num_nodes=big)])
    packed = pack_graphs_aligned(graphs, window=window, node_capacity=4 * window - 1,
                                 edge_capacity=8192, graph_capacity=16,
                                 with_eigen=spec.needs_eigen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the k > 1 note
        batch = base.as_batch(packed, blocked="local_ell", window=window,
                              block=block1 if k == 1 else block2)
    assert base.ell_geometry(batch) == (window, k) and not base.ell_spill_lanes(batch)
    return batch


_ROW18_CASES = [(w, k, d) for w in ROW18_GEOMETRY for k in (1, 2) for d in (100, 112)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,k,d", _ROW18_CASES,
                         ids=[f"W{w}-k{k}-D{d}" for w, k, d in _ROW18_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row18_cuda_kernel_windows_match_plain(window, k, d, dtype, tol, cuda_device):
    """Row 18, the one-layer form of row 4's cluster kernel with the ELL lane
    walk, at W = 128, 256, 512 and 1024 (a cluster of W/128 blocks, the
    large graph's sources read across all of them), k = 1 and 2 edge blocks
    a window, D = 100 and 112 (its two wgmma widths), one launch per call:
    bf16 through the wgmma posttrans with a ring of at least two chunks and
    two blocks an SM, f32 through FMA, one block an SM. f32: summation order
    only; bf16: the output rounds to bf16, and a rounding flip of a channel
    moves it by a few bf16 ulps of its scale."""
    fn = local_layer.dgn_local_layer_ell
    batch = _ell_window_batch("dgn", window, k, 27)
    ops = _port(_dgn_ell_batch_operands(batch, np.random.default_rng(27), d, True), cuda_device,
                dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.stages >= 2 if dtype == torch.bfloat16 else fn.stages == 0
    expect = local_layer.dgn_local_layer_ell_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy("dgn_local_layer_ell_model", dtype, window, (d,), 0, 0,
                                cuda_device)
    assert occ["blocks_per_sm"] == (2 if dtype == torch.bfloat16 else 1) and occ["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row18_knockouts_launch(dtype, cuda_device):
    """The phase split's knockouts of row 18 (bit 0: the posttrans, bit 1:
    the channels) launch and count at W=512; the whole kernel is unchanged
    by having run them. On a CPU tensor a knockout raises."""
    fn = local_layer.dgn_local_layer_ell
    batch = _ell_window_batch("dgn", 512, 1, 27)
    ops = _port(_dgn_ell_batch_operands(batch, np.random.default_rng(27), 100, True),
                cuda_device, dtype)
    full = fn(**ops)
    before = fn.launches
    for knockout in (1, 2, 3):
        assert bool(fn(**ops, knockout=knockout).isfinite().all())
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=1)


def _hot_sentinels(ops: dict, hot: bool) -> dict:
    """Row 17's operands with, in every window, its pad lanes (v = W) turned
    into sentinel lanes from a row that no lane touches, whose scores are
    100 when ``hot``: past float32 exp's overflow, which they must keep out
    of every row."""
    ops = dict(ops)
    meta, w = ops["ell_meta"].copy(), ops["window"]
    n = ops["h"].shape[0]
    lanes = meta.shape[0] // (-(-n // w))
    s_src, s_tgt = ops["s_src"].copy(), ops["s_tgt"].copy()
    for win in range(-(-n // w)):
        m = meta[win * lanes:(win + 1) * lanes]
        real = m[:, 1] < w
        used = set(m[real, 0].tolist()) | set(m[real, 1].tolist())
        free = [r for r in range(w - 1, -1, -1) if r not in used and win * w + r < n]
        pad = np.nonzero(~real)[0]
        if not free or not len(pad):
            continue
        m[pad, 0] = free[0]
        s_src[win * w + free[0]] = s_tgt[win * w + free[0]] = 100.0 if hot else 0.0
    return dict(ops, ell_meta=meta, s_src=s_src, s_tgt=s_tgt)


# Row 17's cases: (H·D, heads) at its edges (H·D 64 and 128, 1, 4 and 32
# heads), at W = 128 and 1024.
_ROW17_CASES = [(w, hd, heads) for w in (128, 1024) for hd in (64, 128) for heads in (1, 4, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,hd,heads", _ROW17_CASES,
                         ids=[f"W{w}-{hd}x{h}" for w, hd, h in _ROW17_CASES])
@pytest.mark.parametrize("sentinels", [False, True], ids=["lanes", "hot-sentinels"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row17_cuda_kernel_widths_match_plain(window, hd, heads, sentinels, dtype, tol,
                                              cuda_device):
    """Row 17 at H·D = 64 and 128 with 1, 4 and 32 heads, W = 128 and 1024,
    against its plain version, in each of its walk shapes (a half-warp a row
    at 4 columns a thread: H·D = 64 up to 16 heads; at 8: H·D = 128 up to
    16 heads; a warp a row: 32 heads); with sentinel lanes whose scores
    overflow exp the output stays finite and equals the run with cold ones,
    bit for bit."""
    fn = local_layer.gat_local_message_ell
    batch = _ell_window_batch("gat", window, 1, 28)
    ops = _gat_ell_batch_operands(batch, np.random.default_rng(28), hd, heads)
    if sentinels:
        ops = _hot_sentinels(ops, False)
    got = fn(**_port(ops, cuda_device, dtype))
    torch.cuda.synchronize()
    expect = local_layer.gat_local_message_ell_ref(**_port(ops, cuda_device, dtype))
    assert got.dtype == dtype and got.shape == expect.shape
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    if sentinels:
        hot = fn(**_port(_hot_sentinels(ops, True), cuda_device, dtype))
        torch.cuda.synchronize()
        assert bool(hot.isfinite().all())
        torch.testing.assert_close(hot, got, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row17_knockout_launches(dtype, cuda_device):
    """The phase split's knockout of row 17 (bit 1: the messages) launches,
    counts and writes zero sums; the whole kernel is unchanged by having run
    it. On a CPU tensor a knockout raises."""
    fn = local_layer.gat_local_message_ell
    batch = _ell_window_batch("gat", 128, 1, 28)
    ops = _port(_gat_ell_batch_operands(batch, np.random.default_rng(28), 64, 4), cuda_device,
                dtype)
    full = fn(**ops)
    before = fn.launches
    out = fn(**ops, knockout=2)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and not bool(out.any())
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=2)


@pytest.mark.cuda
def test_gat_ell_cuda_kernel_overflowing_sentinel_lane_stays_finite(cuda_device):
    """Row 17 on the card: a sentinel lane whose source score overflows exp
    adds nothing; the output is finite and equals the benign run's."""
    outs = [local_layer.gat_local_message_ell(**_port(_gat_ell_overflow_operands(hot), cuda_device))
            for hot in (False, True)]
    torch.cuda.synchronize()
    assert bool(outs[1].isfinite().all())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


# Rows 10, 12 and 25 at the widths of chip_smoke.py's phase 3f (D' and H'
# padded, the models' 100 / 200, H=512) and row 23 at its head geometries
# (4 × 16, and 3 × 16, whose K' pads 48 to 64), at W=128 and W=1024, with
# and without the spill operand (row 25 has none): "W:AxB" as
# ``_width_operands`` reads it.
_WIDTH_CASES = [
    *((k, f"{w}:{d}x{h}", sp) for k in ("gin_local_layer", "gin_local_layer_ell_lanes",
                                        "gin_layer_fused")
      for w in (128, 1024) for d, h in ((36, 72), (100, 200), (100, 512))
      for sp in ((False,) if k == "gin_layer_fused" else (False, True))),
    *(("gat_local_layer_ell", f"{w}:{hd}x{heads}", sp) for w in (128, 1024)
      for hd, heads in ((64, 4), (48, 3)) for sp in (False, True)),
]
_BLOCK_LAYER_CASES = [
    ("gin_local_layer", "W128", False), ("gin_local_layer", "spill", False),
    ("gin_local_layer", "W128", True),
    *(("gin_local_layer_ell_lanes", g, g == "k2") for g in ELL_LAYER_GEOMETRY),
    ("gin_layer_fused", "W128", False), ("gin_layer_fused", "W128", True),
    *(("gat_local_layer_ell", g, sp) for g in ELL_LAYER_GEOMETRY for sp in (True, False)),
    *(("windowed_segment_sum", w, False) for w in (68, 100, 160, 200)),
    *_WIDTH_CASES,
]


def _block_layer_case(kernel: str, geometry, flag: bool):
    """(the wrapper, its plain version, numpy operands) of one case of
    ``_BLOCK_LAYER_CASES``; ``flag`` is the last layer's form for the GIN
    kernels and ``spill_both`` for GAT's, or for a case of ``_WIDTH_CASES``
    (a geometry "W:AxB") the spill operand."""
    if isinstance(geometry, str) and ":" in geometry:
        mod = fused_layer if kernel == "gin_layer_fused" else local_layer
        return (getattr(mod, kernel), getattr(mod, f"{kernel}_ref"),
                _width_operands(kernel, geometry, flag))
    if kernel == "gat_local_layer_ell":
        return (local_layer.gat_local_layer_ell, local_layer.gat_local_layer_ell_ref,
                _gat_layer_operands(geometry, spill=flag))
    if kernel == "windowed_segment_sum":
        return (spmm.windowed_segment_sum, spmm.windowed_segment_sum_ref,
                _blocked_wss_operands(geometry))
    mod = fused_layer if kernel == "gin_layer_fused" else local_layer
    return (getattr(mod, kernel), getattr(mod, f"{kernel}_ref"),
            _gin_blocks_operands(kernel, geometry, final=flag))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,geometry,flag", _BLOCK_LAYER_CASES,
                         ids=[f"{k}-{g}-{int(f)}" for k, g, f in _BLOCK_LAYER_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_rows_10_12_23_25_cuda_kernels_match_plain(kernel, geometry, flag, dtype, tol, cuda_device):
    """Kernel table rows 10 (legacy local layout, with and without crossing
    edges, a layer and the last layer), 12 (ELL at W=128, W=512 and k=2), 25
    (edge-block layout, unaligned packing, empty trailing windows) and 23
    (ELL at the same geometries, with and without ``spill_both``), and row 24
    on the edge-block layout at the four reduction widths, against their plain
    versions, one launch per call; then rows 10, 12, 25 and 23 at the widths
    and windows of ``_WIDTH_CASES`` (both forms: the bf16 products on
    ``wgmma``, H=512 through a shorter weight ring). f32: summation order
    only; bf16: the output rounds to bf16."""
    fn, ref, ops = _block_layer_case(kernel, geometry, flag)
    ops = _port(ops, cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2 and bool(got.isfinite().all())
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gin_layer_ell_ee_keyword_runs_row_12(cuda_device):
    """``gin_local_layer_ell(ee=...)`` launches row 12's kernel, not row 13's,
    and equals row 13 on the embeddings summed from the table (f32 1e-4)."""
    ops = _port(_ell_layer_operands("gin_local_layer_ell", "W128"), cuda_device)
    want = local_layer.gin_local_layer_ell(**ops)
    rows = ops["ell_meta"][:, 2:].long().clamp(0, 12)
    ee = ops["ee_table"][rows].sum(1)
    counts = (local_layer.gin_local_layer_ell.launches,
              local_layer.gin_local_layer_ell_lanes.launches)
    got = local_layer.gin_local_layer_ell(**dict(ops, ee_table=None), ee=ee)
    torch.cuda.synchronize()
    assert (local_layer.gin_local_layer_ell.launches,
            local_layer.gin_local_layer_ell_lanes.launches) == (counts[0], counts[1] + 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_rows_10_23_25_cuda_kernels_reject_geometry(cuda_device):
    """Each new wrapper raises before launch on what its kernel cannot take:
    a window that is not whole 128-row tiles or past 1024 rows, row 23 an
    H·D past its products' width (128 > 64) or more heads than a warp's
    lanes (64 > 32), rows 10 and 25 a D past their tile (128 > 112), a row
    read as column pairs that does not start on a pair, and a ``prev`` that
    row 23 copies 16 bytes at a time off 16-byte alignment."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    i32 = lambda *s: torch.full(s, 128, dtype=torch.int32, device=cuda_device)
    mlp = lambda d: dict(w1=t(8, d), b1=t(8), w2=t(d, 8), b2=t(d), eps1=t(1, 1), final_relu=True)
    gat = lambda hd, window: dict(
        ell_meta=i32(16, 5), h=t(256, hd), s_src=t(256, 4), s_tgt=t(256, 4), prev=t(256, hd),
        spill_both=None, w_skip=t(hd, hd), w_proj=t(hd, hd), a_mat=t(hd, 8), window=window,
        num_heads=4)
    local = lambda d, window: dict(ee=t(256, d), u_local=i32(256), v_local=i32(256),
                                   block_window=torch.zeros(2, dtype=torch.int32,
                                                            device=cuda_device),
                                   h=t(256, d), m_spill=None, window=window, **mlp(d))
    fused = lambda d, window: dict(vals=t(256, d), v_local=i32(256),
                                   block_window=torch.zeros(2, dtype=torch.int32,
                                                            device=cuda_device),
                                   h=t(256, d), window=window, **mlp(d))
    odd = lambda d: t(256 * d + 1)[1:].view(256, d)  # rows one element past a pair
    cases = [
        (local_layer.gat_local_layer_ell, gat(64, 192), "whole blocks"),
        (local_layer.gat_local_layer_ell, gat(64, 1152), "whole blocks"),
        (local_layer.gat_local_layer_ell, gat(128, 128), "tile"),
        (local_layer.gat_local_layer_ell,
         dict(gat(64, 128), s_src=t(256, 64), s_tgt=t(256, 64), a_mat=t(64, 128), num_heads=64),
         "num_heads"),
        (local_layer.gat_local_layer_ell, dict(gat(64, 128), prev=odd(64)), "16-byte"),
        (local_layer.gin_local_layer, local(32, 192), "whole blocks"),
        (local_layer.gin_local_layer, local(32, 1152), "whole blocks"),
        (local_layer.gin_local_layer, local(128, 128), "tile"),
        (local_layer.gin_local_layer, dict(local(32, 128), ee=odd(32)), "pairs"),
        (fused_layer.gin_layer_fused, fused(32, 192), "whole blocks"),
        (fused_layer.gin_layer_fused, fused(128, 128), "tile"),
        (fused_layer.gin_layer_fused, dict(fused(32, 128), vals=odd(32)), "pairs"),
    ]
    for fn, kw, match in cases:
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(**kw)
        assert fn.launches == before


# Rows 10, 12, 25 and 23 in the phase split of chip_smoke.py: the W=1024
# cases of ``_WIDTH_CASES`` at the models' widths, with the spill operand.
_KNOCKOUT_CASES = [("gin_local_layer", "1024:100x200", True),
                   ("gin_local_layer_ell_lanes", "1024:100x200", True),
                   ("gin_layer_fused", "1024:100x200", False),
                   ("gat_local_layer_ell", "1024:64x4", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,geometry,spill", _KNOCKOUT_CASES,
                         ids=[c[0] for c in _KNOCKOUT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_10_12_23_25_knockouts_launch(kernel, geometry, spill, dtype, cuda_device):
    """The phase split's knockouts of rows 10, 12, 25 and 23 (bit 0: the MLP
    or both products, bit 1: the messages) launch and count; the whole
    kernel is unchanged by having run them. On a CPU tensor a knockout
    raises."""
    fn, _, ops = _block_layer_case(kernel, geometry, spill)
    ops = _port(ops, cuda_device, dtype)
    full = fn(**ops)
    before = fn.launches
    for knockout in (1, 2, 3):
        fn(**ops, knockout=knockout)
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=1)


@pytest.mark.cuda
def test_gat_layer_ell_cuda_kernel_overflowing_sentinel_lane_stays_finite(cuda_device):
    """Row 23 on the card: a sentinel lane whose source score overflows exp
    adds nothing; the rows it does not own are finite and equal the benign
    run's."""
    outs = [local_layer.gat_local_layer_ell(**_port(_gat_layer_overflow_operands(hot), cuda_device))
            for hot in (False, True)]
    torch.cuda.synchronize()
    keep = torch.arange(W, device=cuda_device) != 20
    assert bool(outs[1][keep].isfinite().all())
    torch.testing.assert_close(outs[1][keep], outs[0][keep], rtol=0, atol=0)


# The chained matmul (row 26): (M, K, N, layers, grid, dtype), the CPU
# test's shapes, two of SHAPES at full size, and the cases of the wgmma
# layouts (the kernel's plan): K = 64 at N = 136 (rows mode, B resident),
# K = 512 (rows mode, B streamed), K = 1024 (columns mode, B streamed), N
# padded to the wgmma width (72 -> 128, 200 -> 256), int8 with N > 128
# (columns mode), each at a row count that is not a multiple of the slab.
_CHAIN_CASES = [(8, 64, 128, 1, 2, "bf16"), (64, 128, 136, 3, 2, "bf16"),
                (8, 64, 136, 3, 2, "int8"), (64, 128, 128, 1, 2, "int8"),
                matmul_shapes.SHAPES[0][1:], matmul_shapes.SHAPES[6][1:],
                (40, 64, 136, 5, 3, "bf16"), (100, 512, 128, 3, 3, "bf16"),
                (100, 1024, 256, 3, 3, "bf16"), (100, 1024, 256, 3, 3, "int8"),
                (50, 256, 128, 5, 3, "int8"), (100, 128, 256, 5, 3, "bf16"),
                (24, 96, 72, 2, 3, "bf16"), (24, 96, 200, 2, 3, "int8")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,layers,grid,dtype", _CHAIN_CASES,
                         ids=["-".join(map(str, c)) for c in _CHAIN_CASES])
@pytest.mark.parametrize("ones", [True, False], ids=["ones", "seeded"])
def test_chained_matmul_cuda_kernel_matches_plain(m, k, n, layers, grid, dtype, ones, cuda_device):
    """All-ones: layers·K exactly. Seeded: int8 exact (integer products,
    the f32 sums in layer order), bf16 at 1e-4 of the largest output (the
    K-sum order of the tensor cores against cuBLAS's)."""
    if ones:
        a, b = matmul_shapes.operands(m, k, n, grid, dtype, cuda_device)
    else:
        rng = np.random.default_rng(m + k + n)
        if dtype == "int8":
            draw = lambda *s: torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))
        else:
            draw = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
                torch.bfloat16)
        a, b = draw(grid * m, k).to(cuda_device), draw(k, n).to(cuda_device)
    before = matmul_shapes.chained_matmul.launches
    got = matmul_shapes.chained_matmul(a, b, layers, grid)
    torch.cuda.synchronize()
    assert matmul_shapes.chained_matmul.launches == before + 1
    want = matmul_shapes.chained_matmul_ref(a, b, layers, grid)
    if ones:
        assert bool((got == layers * k).all())
    elif dtype == "int8":
        assert torch.equal(got, want)
    else:
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_chained_matmul_cuda_kernel_rejects(cuda_device):
    """A wrong dtype, a non-contiguous operand, K not a multiple of 32, N
    past 256: raises before launch."""
    bf = lambda *s: torch.ones(*s, dtype=torch.bfloat16, device=cuda_device)
    cases = [
        ((bf(16, 64).float(), bf(64, 128).float()), TypeError),
        ((bf(64, 16).T, bf(64, 128)), ValueError),
        ((bf(16, 48), bf(48, 128)), ValueError),
        ((bf(16, 64), bf(64, 264)), ValueError),
    ]
    before = matmul_shapes.chained_matmul.launches
    for (a, b), err in cases:
        with pytest.raises(err):
            matmul_shapes.chained_matmul(a, b, 1, 1)
    assert matmul_shapes.chained_matmul.launches == before


_ABL_PAIRS = [(f, v) for f, (names, _) in ablate_gat_mega.FORMS.items() for v in names]


@pytest.mark.cuda
@pytest.mark.parametrize("form,variant", _ABL_PAIRS, ids=[f"{f}-{v}" for f, v in _ABL_PAIRS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gat_mega_ablate_cuda_kernel_matches_plain(form, variant, dtype, tol, cuda_device):
    """Every (form, variant) of rows 27-30 against its plain version, one
    launch each. f32: summation order only; bf16: a rounding flip at one
    stage propagates through the later layer. ``noexp`` on nonnegative
    operands (``_ablation_operands``)."""
    ops = _port(_ablation_call(form, _ablation_operands(positive=variant == "noexp")),
                cuda_device, dtype)
    before = ablate_gat_mega.gat_mega_ablate.launches
    got = ablate_gat_mega.gat_mega_ablate(form, variant, **ops)
    torch.cuda.synchronize()
    assert ablate_gat_mega.gat_mega_ablate.launches == before + 1
    want = ablate_gat_mega.gat_mega_ablate_ref(form, variant, **ops)
    assert bool(got.isfinite().all()) and want.abs().max() > 1e-2
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(ablate_gat_mega.FORMS))
def test_gat_mega_ablate_cuda_full_width(form, cuda_device):
    """Each form's ``full`` at full width (4 heads × 16, L=5) on a 256-graph
    molhiv bucket, f32: against its plain version and against row 5's
    kernel, 1e-4 (summation order, and v3-v5's composed score maps)."""
    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import gat
    from flowgnn_tpu_torch.params import loaders

    batch = ablate_gat_mega.molhiv_bucket(256, None, cuda_device)
    params = loaders.params_from_numpy(loaders.synthetic_gat_params(0), FLOAT32, cuda_device)
    ops = ablate_gat_mega.form_operands(
        form, ablate_gat_mega.ablation_operands(params, batch, FLOAT32))
    got = ablate_gat_mega.gat_mega_ablate(form, "full", **ops)
    row5 = local_layer.gat_local_model_slots(**gat.slot_kernel_operands(params, batch, FLOAT32))
    want = ablate_gat_mega.gat_mega_ablate_ref(form, "full", **ops)
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    for ref in (want, row5):
        torch.testing.assert_close(got / scale, ref / scale, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_gat_mega_ablate_cuda_kernel_rejects(cuda_device):
    """A wrong dtype, a non-contiguous operand, W > 128, nopool past the
    window's rows: raises before launch."""
    fn = ablate_gat_mega.gat_mega_ablate
    ops = _port(_ablation_call("v3", _ablation_operands()), cuda_device)
    wide = dict(ops, window=256, h0=ops["h0"])
    cases = [
        (dict(ops, h0=ops["h0"].double()), "full", TypeError),
        (dict(ops, x0=ops["x0"].T.contiguous().T), "full", ValueError),
        (wide, "full", ValueError),
        (dict(ops, gmax=ABL_W + 1), "nopool", ValueError),
        (dict(ops, stack=ops["stack"].float()), "full", TypeError),
    ]
    before = fn.launches
    for kw, variant, err in cases:
        with pytest.raises(err):
            fn("v3", variant, **kw)
    assert fn.launches == before
