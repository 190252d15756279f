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
# last padded), 2 heads × 8, 2 layers, prefix caps (128, 64, 32). At W = 256
# and 512 (clusters of two and four blocks) two windows of 2W − 6 rows, caps
# whose lanes i mod W and random sources reach every block.
ABL_W, ABL_NW, ABL_N = 128, 2, 250
ABL_HEADS, ABL_L, ABL_T = 2, 2, 1
ABL_CAPS = (128, 64, 32)
ABL_WINDOW_CAPS = {128: ABL_CAPS, 256: (256, 160, 96), 512: (512, 320, 192)}


def _ablation_operands(seed: int = 0, positive: bool = False, window: int = ABL_W) -> dict:
    """Seeded numpy operands of every ablation form at ``window``: random
    sources (a quarter of the lanes empty), prefix stacks with the window's
    caps (``ABL_WINDOW_CAPS``), graph ids per row, v4's one-hot tiles and
    v5's expanded scores. With ``positive`` every float operand is |N(0,
    sd)|: then every score, h and feat stays nonnegative, which ``noexp``
    needs to be well conditioned (it divides by the sum of the raw, signed
    scores, which otherwise cancels towards zero and multiplies the f32
    rounding of the glue products by up to ~1e3)."""
    w, nw, heads, layers = window, ABL_NW, ABL_HEADS, ABL_L
    n = ABL_N if window == ABL_W else 2 * window - 6
    caps = ABL_WINDOW_CAPS[window]
    hd = heads * 8
    pay = max(128, hd + heads)
    rng = np.random.default_rng(seed)
    sign = np.abs if positive else (lambda x: x)
    f = lambda *s, sd=0.5: sign(rng.normal(0, sd, s)).astype(np.float32)
    src = lambda *s: np.where(rng.random(s) < 0.75, rng.integers(0, w, s), w).astype(np.int32)
    pstack = np.full((nw, sum(caps)), w, np.int32)
    off = 0
    for c in caps:
        pstack[:, off : off + c] = src(nw, c)
        off += c
    glue_w = f((layers - 1) * hd, pay + hd + heads, sd=0.3)
    glue_w[:, hd + heads : pay] = 0
    gl = np.full(nw * w, base.POOL_GMAX, np.int32)
    gl[:n] = np.sort(rng.integers(0, 20, n))
    ops = dict(
        slot_stack=src(nw * len(caps) * w), slot_pstack=pstack.reshape(-1), h0=f(n, hd),
        prev0=f(n, hd), skip0=f(n, hd), s0=f(n, 2 * heads), skip_w=f(layers * hd, hd, sd=0.3),
        proj_w=f((layers - 1) * hd, hd, sd=0.3), a_next=f((layers - 1) * hd, 2 * heads, sd=0.3),
        glue_w=glue_w, pool_gl=gl, pred_hd=f(hd, ABL_T),
    )
    ops["onehot_tiles"] = ablate_gat_mega.onehot_tiles(
        torch.from_numpy(ops["slot_pstack"]), w, sum(caps), torch.float32).numpy()
    gx, sx = ablate_gat_mega.expand_score_operands(torch.from_numpy(glue_w),
                                                   torch.from_numpy(ops["s0"]), hd, heads)
    ops["glue_wx"], ops["s0x"] = gx.numpy(), sx.numpy()
    return ops


def _ablation_call(form: str, ops: dict, window: int = ABL_W) -> dict:
    """``gat_mega_ablate``'s keyword operands of ``form`` (numpy) at
    ``window``."""
    caps = ABL_WINDOW_CAPS[window]
    c = dict(ops, window=window, slots=len(caps), num_heads=ABL_HEADS, num_layers=ABL_L,
             gmax=base.POOL_GMAX, prefix_caps=caps, caps_v4=caps)
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
# The same at W=384, a cluster of three (rows 16 and 19 run it too).
WINDOW_GEOMETRY = {**ROW18_GEOMETRY, 384: (350, 1536, 512)}


def _ell_window_batch(name: str, window: int, k: int, seed: int) -> dict:
    """ELL layout (numpy) of 6 synthetic graphs and one of ``ROW18_GEOMETRY``'s
    large ones for model ``name`` at ``window``, k edge blocks a window, no
    spill tail (GAT, whose self loops add a lane a row: k = 1, blocks of 4W
    lanes)."""
    big, block1, block2 = WINDOW_GEOMETRY[window]
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


def _gcn_ell_batch_operands(batch: dict, rng, d: int, final: bool) -> dict:
    """Row 15's seeded operands at width ``d`` on an ELL batch, as numpy
    arrays: the layout's own degree norms, a bond table of 13 rows, and on
    every layer but the last (``final``) the next conv."""
    f32 = lambda *s, sd=0.3: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    return dict(_ell_lane_operands(batch), h=f32(n, d),
                dis=(1 / np.sqrt(batch["out_deg"] + 1.0)).astype(np.float32),
                ee_table=f32(13, d), root=f32(d), alpha=(1 + f32(d)).astype(np.float32),
                beta=f32(d), w_next=None if final else f32(d, d, sd=0.1),
                b_next=None if final else f32(d))


_ROW15_CASES = [(w, k, d, final) for w in ROW18_GEOMETRY for k in (1, 2) for d in (100, 112)
                for final in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,k,d,final", _ROW15_CASES,
                         ids=[f"W{w}-k{k}-D{d}{'-final' if f else ''}"
                              for w, k, d, f in _ROW15_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row15_cuda_kernel_windows_match_plain(window, k, d, final, dtype, tol, cuda_device):
    """Row 15, the one-layer form of row 9's cluster kernel with the ELL lane
    walk, at W = 128, 256, 512 and 1024 (a cluster of W/128 blocks, the
    large graph's sources read across all of them), k = 1 and 2 edge blocks
    a window, D = 100 and 112 (its two wgmma widths), on a non-final layer
    (bf16: the next conv through wgmma with a ring of at least two chunks;
    f32: FMA on weights streamed in chunks; two blocks an SM but for f32 at
    D=112) and on the last (no conv), one launch per call. f32: summation order only; bf16: the output
    rounds to bf16, and a rounding flip of a message or of the conv's input
    moves it by a few bf16 ulps of its scale."""
    fn = local_layer.gcn_local_layer_ell
    batch = _ell_window_batch("gcn", window, k, 27)
    ops = _port(_gcn_ell_batch_operands(batch, np.random.default_rng(29), d, final), cuda_device,
                dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.stages >= 2 if dtype == torch.bfloat16 else fn.stages == 0
    expect = local_layer.gcn_local_layer_ell_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy("gcn_local_layer_ell", dtype, window, (d, 13), 0, 0, cuda_device)
    # f32 at D=112: h and x alone take 114.7 KB a block, one block an SM.
    assert occ["blocks_per_sm"] == (1 if dtype == torch.float32 and d == 112 else 2)
    assert occ["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row15_knockouts_launch(dtype, cuda_device):
    """The phase split's knockouts of row 15 (bit 0: the next conv, bit 1:
    the messages) launch and count at W=512, on a non-final layer and on
    the last, and leave a finite output; the whole kernel is unchanged by
    having run them. On a CPU tensor a knockout raises."""
    fn = local_layer.gcn_local_layer_ell
    batch = _ell_window_batch("gcn", 512, 1, 27)
    for final in (False, True):
        ops = _port(_gcn_ell_batch_operands(batch, np.random.default_rng(29), 100, final),
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


# Row 14's cases: every window its clusters take (``ROW18_GEOMETRY``'s
# buckets), k = 1 and 2 edge blocks a window, D at its edges: odd (37), the
# model's (100) and the widest (128).
_ROW14_CASES = [(w, k, d) for w in ROW18_GEOMETRY for k in (1, 2) for d in (37, 100, 128)]


def _row14_operands(window: int, k: int, d: int, seed: int = 33) -> dict:
    """Row 14's seeded operands at width ``d`` on a ``ROW18_GEOMETRY`` bucket,
    as numpy arrays: the layout's own degree norms, a 13-row bond table, h
    and dis cut 5 rows short of the last window (its padding rows), and lanes
    turned so that each kind of lane that gives no message is there: in every
    window a real lane's u set outside [0, W) (past it, and negative) and the
    pad lanes (v = W) given a live source, which must land nowhere; in the
    last window, which holds no edge, a lane from a padding row to row 0 and
    one from row 0 to a padding row."""
    batch = _ell_window_batch("gcn", window, k, 27)
    rng = np.random.default_rng(seed)
    n = batch["node_feat"].shape[0] - 5
    f32 = lambda *s, sd=0.3: rng.normal(0, sd, s).astype(np.float32)
    ops = dict(_ell_lane_operands(batch), h=f32(n, d),
               dis=(1 / np.sqrt(batch["out_deg"][:n] + 1.0)).astype(np.float32),
               ee_table=f32(13, d))
    return dict(ops, ell_meta=_turned_lanes(ops["ell_meta"], n, window))


def _turned_lanes(ell_meta: np.ndarray, n: int, window: int) -> np.ndarray:
    """``ell_meta`` with each kind of lane that adds nothing: in every window
    a real lane's u set outside [0, W) (past it, and negative) and the pad
    lanes (v = W) given a live source, which must land nowhere; in the last
    window, which must hold no edge, a lane from a padding row (n rows of
    the windows' are real) to row 0 and one from row 0 to a padding row."""
    meta = ell_meta.copy()
    nw = -(-n // window)
    lanes = meta.shape[0] // nw
    for win in range(nw):
        m = meta[win * lanes:(win + 1) * lanes]
        real = np.nonzero(m[:, 1] < window)[0]
        if len(real) >= 2:
            m[real[0], 0], m[real[1], 0] = window + 3, -2
        m[m[:, 1] >= window, 0] = 0
    last = meta[(nw - 1) * lanes:]
    assert not (last[:, 1] < window).any()
    last[0, :2] = window - 2, 0
    last[1, :2] = 0, window - 1
    return meta


@pytest.mark.cuda
@pytest.mark.parametrize("window,k,d", _ROW14_CASES,
                         ids=[f"W{w}-k{k}-D{d}" for w, k, d in _ROW14_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row14_cuda_kernel_windows_match_plain(window, k, d, dtype, tol, cuda_device):
    """Row 14, the messages-only form of row 9's cluster kernel with the ELL
    lane walk, at W = 128, 256, 512 and 1024 (a cluster of W/128 blocks,
    the large graph's sources read across all of them), k = 1 and 2 edge
    blocks a window, D = 37 (odd: a padded row stride in shared memory),
    100 and 128, with sentinel, out-of-window and padding-row lanes, one
    launch per call. f32: summation order only; bf16: the output rounds to
    bf16 (a rounding flip of a message moves it by a bf16 ulp or so of its
    scale)."""
    fn = local_layer.gcn_local_message_ell
    ops = _port(_row14_operands(window, k, d), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = local_layer.gcn_local_message_ell_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy("gcn_local_message_ell", dtype, window, (d, 13), 0, 0,
                                cuda_device)
    # Blocks of 512 threads at up to 64 registers: two an SM.
    assert occ["stages"] == 0 and occ["blocks_per_sm"] == 2 and occ["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row14_knockout_launches(dtype, cuda_device):
    """The phase split's knockout of row 14 (bit 1: the messages) launches,
    counts and writes zeros at W=512; the whole kernel is unchanged by having
    run it. On a CPU tensor a knockout raises."""
    fn = local_layer.gcn_local_message_ell
    ops = _port(_row14_operands(512, 1, 100), cuda_device, dtype)
    full = fn(**ops)
    before = fn.launches
    out = fn(**ops, knockout=2)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert not out.any()
    assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=2)


@pytest.mark.cuda
def test_row14_cuda_kernel_rejects_geometry(cuda_device):
    """Row 14 raises before launch on a D past its 128 columns and on a
    window that is not whole 128-row blocks."""
    fn = local_layer.gcn_local_message_ell
    before = fn.launches
    ops = _port(_row14_operands(128, 1, 128), cuda_device)
    rng = np.random.default_rng(0)
    wide = dict(ops, h=torch.from_numpy(rng.normal(size=(ops["h"].shape[0], 129)).astype(
        np.float32)).to(cuda_device), ee_table=torch.zeros(13, 129, device=cuda_device))
    with pytest.raises(ValueError, match="tile"):
        fn(**wide)
    with pytest.raises(ValueError, match="whole blocks"):
        fn(**dict(ops, window=192))
    assert fn.launches == before


_ROW16_CASES = [(w, k, d) for w in sorted(WINDOW_GEOMETRY) for k in (1, 2)
                for d in (1, 37, 100, 128)]


def _row16_operands(window: int, k: int, d: int, seed: int = 35) -> dict:
    """Row 16's seeded operands at width ``d`` on a ``WINDOW_GEOMETRY`` ELL
    bucket, as numpy arrays: h and random eigenvector entries cut 5 rows
    short of the last window (its padding rows), the lanes turned by
    ``_turned_lanes``."""
    batch = _ell_window_batch("gcn", window, k, 27)
    rng = np.random.default_rng(seed)
    n = batch["node_feat"].shape[0] - 5
    lanes = _ell_lane_operands(batch)
    return dict(lanes, ell_meta=_turned_lanes(lanes["ell_meta"], n, window),
                h=rng.normal(0, 0.5, (n, d)).astype(np.float32),
                eig=rng.normal(0, 0.3, n).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("window,k,d", _ROW16_CASES,
                         ids=[f"W{w}-k{k}-D{d}" for w, k, d in _ROW16_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row16_cuda_kernel_windows_match_plain(window, k, d, dtype, tol, cuda_device):
    """Row 16, the channels-only form of row 4's cluster kernel with the ELL
    runs, at W = 128, 256, 384, 512 and 1024 (a cluster of W/128 blocks, the
    large graph's sources read across all of them), k = 1 and 2 edge blocks
    a window, D = 1, 37 (odd: a padded row stride in shared memory), 100 (the
    model's) and 128, with sentinel, out-of-window and padding-row lanes, one
    launch per call; then what the occupancy calculator says of it. f32:
    summation order only; bf16: the output rounds to bf16, and a rounding
    flip of a lane's e_u·h_u moves m2 by a few bf16 ulps of its scale."""
    fn = local_layer.dgn_local_message_ell
    ops = _port(_row16_operands(window, k, d), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = local_layer.dgn_local_message_ell_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    occ = local_layer.occupancy("dgn_local_layer_ell", dtype, window, (d,), 0, 0, cuda_device)
    assert occ["stages"] == 0 and occ["blocks_per_sm"] >= 1 and occ["clusters"] > 0


def _row19_operands(window: int, d: int, slots: int, seed: int = 36) -> dict:
    """Row 19's seeded operands at width ``d`` and ``slots`` slots over three
    windows of ``window`` rows, 5 of them padding rows, as numpy arrays:
    each row's slots drawn from the whole window (sources in every block of
    its cluster, padding rows among them), a quarter of them the sentinel W,
    and every eleventh row with no source at all (it keeps the seeds)."""
    from flowgnn_tpu_torch.models.pna import MAX_INIT, MIN_INIT

    rng = np.random.default_rng(seed)
    rows = 3 * window
    src = rng.integers(0, window, (rows, slots)).astype(np.int32)
    src[rng.random((rows, slots)) < 0.25] = window
    src[::11] = window
    return dict(slot_src=src, h=rng.normal(0, 2.0, (rows - 5, d)).astype(np.float32),
                window=window, slots=slots, min_init=MAX_INIT, max_init=MIN_INIT)


_ROW19_CASES = [(w, d, s) for w in sorted(WINDOW_GEOMETRY) for d in (1, 37, 80, 128)
                for s in (1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,d,slots", _ROW19_CASES,
                         ids=[f"W{w}-D{d}-S{s}" for w, d, s in _ROW19_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row19_cuda_kernel_windows_match_plain(window, d, slots, dtype, tol, cuda_device):
    """Row 19, the stats-only form of row 3's cluster kernel, at W = 128,
    256, 384, 512 and 1024 (a cluster of W/128 blocks; each row's sources
    anywhere in its window), D = 1, 37 (odd: a padded row stride in shared
    memory), 80 (the model's) and 128, 1 and 8 slots, with sentinel slots,
    padding-row sources and rows with no source, one launch per call; then
    what the occupancy calculator says of it. f32: summation order is the
    plain version's, so the sums agree to its rounding; bf16: the output
    rounds to bf16 (a flip is one bf16 ulp of the output)."""
    fn = local_layer.pna_local_stats_ell
    ops = _port(_row19_operands(window, d, slots), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = local_layer.pna_local_stats_ell_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    assert torch.equal(got[::11], expect[::11])  # no source: the seeds
    occ = local_layer.occupancy("pna_local_stats_slots", dtype, window, (d,), 0, 0, cuda_device)
    assert occ["stages"] == 0 and occ["blocks_per_sm"] >= 1 and occ["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_16_19_knockouts_launch(dtype, cuda_device):
    """The phase split's knockout of rows 16 and 19 (bit 1: the channels, the
    stats) launches, counts and writes zeros at W=512; the whole kernel is
    unchanged by having run it. On a CPU tensor a knockout raises."""
    for fn, ops in ((local_layer.dgn_local_message_ell, _row16_operands(512, 1, 100)),
                    (local_layer.pna_local_stats_ell, _row19_operands(512, 80, 8))):
        ops = _port(ops, cuda_device, dtype)
        full = fn(**ops)
        before = fn.launches
        out = fn(**ops, knockout=2)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert out.shape == full.shape and not out.any()
        assert torch.equal(fn(**ops), full)
        with pytest.raises(ValueError, match="knockout"):
            fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=2)


@pytest.mark.cuda
def test_rows_16_19_cuda_kernels_reject_geometry(cuda_device):
    """Rows 16 and 19 raise before launch on a D past their 128 columns, on a
    window that is not whole 128-row blocks or spans more than 8, and row 19
    on more than 8 slots; W=1024 at D=128 and 8 slots runs (row 19's old
    one-block form ran out of shared memory there)."""
    rng = np.random.default_rng(0)
    for fn, ops in ((local_layer.dgn_local_message_ell, _row16_operands(128, 1, 100)),
                    (local_layer.pna_local_stats_ell, _row19_operands(128, 80, 8))):
        ops = _port(ops, cuda_device)
        n = ops["h"].shape[0]
        wide = torch.from_numpy(rng.normal(size=(n, 129)).astype(np.float32)).to(cuda_device)
        before = fn.launches
        with pytest.raises(ValueError, match="tile"):
            fn(**dict(ops, h=wide))
        for window in (192, 1152):
            with pytest.raises(ValueError, match="whole blocks"):
                fn(**dict(ops, window=window))
        assert fn.launches == before
    ops = _port(_row19_operands(128, 80, 8), cuda_device)
    with pytest.raises(ValueError, match="slots"):
        local_layer.pna_local_stats_ell(**dict(ops, slot_src=ops["slot_src"].repeat(1, 2)[:, :9],
                                               slots=9))
    ops = _port(_row19_operands(1024, 128, 8), cuda_device)
    got = local_layer.pna_local_stats_ell(**ops)
    expect = local_layer.pna_local_stats_ell_ref(**ops)
    scale = expect.abs().max().item()
    torch.testing.assert_close(got / scale, expect / scale, rtol=1e-4, atol=1e-4)


def _long_run_operands(window: int, d: int, seed: int = 34) -> dict:
    """Row 24's operands with one window whose run is longer than the index
    pass's list (``windowed_segment_sum``'s chunk, 4096 lanes): four
    windows of ``window`` rows in blocks of 128 lanes; window 0 two blocks of
    lanes, window 1 a run of three lists' worth and more (a hub row at v = 7
    with 5,000 lanes, the rest on random rows, and a tenth sentinels), its
    lanes in random order, window 2 one block, then blocks of sentinels parked
    on window 2; window 3 has no block. Values carry a value on every lane,
    sentinels too, which must add nothing."""
    rng = np.random.default_rng(seed)
    block, chunk = 128, 4096
    hub = np.full(5000, 7)
    rest = rng.integers(0, window, 3 * chunk)
    v1 = np.concatenate([hub, rest, np.full(1300, window)])
    v1 = rng.permutation(v1)
    v1 = np.concatenate([v1, np.full(-len(v1) % block, window)])
    v0 = rng.integers(0, window, 2 * block)
    v2 = np.concatenate([rng.integers(0, window, block), np.full(40 * block, window)])
    v = np.concatenate([v0, v1, v2]).astype(np.int32)
    bw = np.repeat(np.arange(3), [len(v0) // block, len(v1) // block, len(v2) // block])
    return dict(values=rng.normal(0, 0.5, (len(v), d)).astype(np.float32), v_local=v[:, None],
                block_window=bw.astype(np.int32), window=window, num_windows=4)


def _shuffled_spill_operands(width: int) -> dict:
    """Row 24's operands on the spill layout (``_layer_operands``: windows of
    512 rows, the T compact windows) at width ``width``, each window's lanes
    shuffled within its run: the kernel takes v in no order."""
    ops = _layer_operands("windowed_segment_sum")
    rng = np.random.default_rng(35)
    v, bw = ops["v_local"][:, 0].copy(), ops["block_window"]
    block = v.shape[0] // bw.shape[0]
    lane_window = np.repeat(bw, block)
    for t in np.unique(bw):
        at = np.nonzero(lane_window == t)[0]
        v[at] = v[rng.permutation(at)]
    return dict(ops, v_local=v[:, None],
                values=rng.normal(0, 0.5, (v.shape[0], width)).astype(np.float32))


# Row 24's cases: (layout, width). The spill layout (W=512, compact windows,
# shuffled within each window) at D' = 200 and odd 37; the edge-block layout
# (W=128, parked sentinel blocks) at each model's width and odd 37; a window
# whose run passes the list, at W = 128 and 512.
_ROW24_CASES = [("spill", 200), ("spill", 37), *(("blocks", w) for w in (68, 100, 160, 200, 37)),
                ("long128", 100), ("long512", 100), ("long128", 37)]


def _row24_operands(layout: str, width: int) -> dict:
    if layout == "spill":
        return _shuffled_spill_operands(width)
    if layout == "blocks":
        return _blocked_wss_operands(width)
    return _long_run_operands(int(layout[4:]), width)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,width", _ROW24_CASES,
                         ids=[f"{l}-D{w}" for l, w in _ROW24_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row24_cuda_kernel_layouts_match_plain(layout, width, dtype, tol, cuda_device):
    """Row 24, one block per output window and 128-row slice over per-row
    lane lists, against its plain version: the spill layout with its lanes
    in no order, the edge-block layout with its parked sentinel blocks, a
    window whose run is longer than the list (a hub row past it, the other
    rows in groups) and a window with no block (zeros), at widths whose row
    bytes take 16-, 8-, 4- and 2-byte vectors; two launches give equal bits.
    f32: summation order only; bf16: the output rounds to bf16 once."""
    fn = spmm.windowed_segment_sum
    ops = _port(_row24_operands(layout, width), cuda_device, dtype)
    before = fn.launches
    got = fn(**ops)
    again = fn(**ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    expect = spmm.windowed_segment_sum_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    if layout.startswith("long"):
        assert not got.reshape(4, -1)[3].any()  # window 3 has no block


def _fixed_messages(name: str) -> tuple:
    """Layer 0's fixed-mode messages on ``_edge_block_batch(name)``, the
    model's seeded weights at full width snapped to its grid (CPU tensors):
    GIN's relu(h_u + ee), on the 2^-10 grid; DGN's [h_u ‖ eig_w·h_u], whose
    products lie on a finer grid. Returns (values, the batch, the spec)."""
    from flowgnn_tpu_torch.core.numerics import Precision
    from flowgnn_tpu_torch.models import dgn
    from flowgnn_tpu_torch.params import loaders

    spec = registry.get(name).fixed_spec
    prec = Precision(fixed=spec)
    batch = base.to_device(_edge_block_batch(name), "cpu")
    u = batch["senders"].long()
    if name == "gin":
        p = loaders.params_from_numpy(loaders.synthetic_gin_params(0), prec, "cpu")
        h = base.atom_embed(p["node_embedding"], batch["node_feat"], prec)
        ee = base.bond_embed(p["edge_embedding"][0], batch["edge_attr"], prec)
        return base.relu(h[u] + ee), batch, spec
    p = loaders.params_from_numpy(loaders.synthetic_dgn_params(0), prec, "cpu")
    h = dgn._atom_embed_dgn(p["atom_tables"], batch["node_feat"], prec)
    eig_w = dgn._node_terms(batch, prec)[1]
    return torch.cat([h[u], eig_w[:, None] * h[u]], dim=1), batch, spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "dgn"])
def test_row24_fixed_mode_messages_match_plain(name, cuda_device):
    """Row 24's f32 form on the fixed mode's messages (``segment_sum_blocked``,
    every model's message sum on an edge-block batch) against its plain
    version on the card. GIN's messages are grid values whose partial sums
    stay below 2^14, exact in f32 in any order: bit-equal. DGN's products
    are not: its sums agree to f32 rounding (1e-6 of the largest), and
    quantized to ap_fixed<16,3> within one grid ulp."""
    vals, batch, spec = _fixed_messages(name)
    n = base.num_nodes_static(batch)
    ops = [t.to(cuda_device) for t in (vals, batch["blk_vlocal"], batch["blk_window"])]
    before = spmm.windowed_segment_sum.launches
    got = spmm.segment_sum_blocked(*ops, n, base.PALLAS_WINDOW)
    torch.cuda.synchronize()
    assert spmm.windowed_segment_sum.launches == before + 1
    expect = spmm.windowed_segment_sum_ref(ops[0], ops[1][:, None], ops[2], base.PALLAS_WINDOW,
                                           -(-n // base.PALLAS_WINDOW))[:n]
    assert got.dtype == torch.float32 and expect.abs().max() > 1
    if name == "gin":
        assert torch.equal(got, expect)
        return
    scale = expect.abs().max().item()
    assert (got - expect).abs().max().item() <= 1e-6 * scale
    ulps = (spec.quantize(got) - spec.quantize(expect)).abs().max().item() * spec.scale
    assert ulps <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row24_cuda_kernel_takes_unaligned_values(dtype, cuda_device):
    """Values that start off a 16-byte boundary (a view one element in) take
    narrower vectors: the plan follows the pointers' alignment, and the sums
    are the aligned launch's, bit for bit."""
    fn = spmm.windowed_segment_sum
    ops = _port(_blocked_wss_operands(200), cuda_device, dtype)
    vals = ops["values"]
    flat = torch.empty(vals.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = flat[1:].view(vals.shape)
    shifted.copy_(vals)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(fn(**dict(ops, values=shifted)), fn(**ops), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row24_knockout_launches(dtype, cuda_device):
    """The phase split's knockout of row 24 (bit 1: the sums; the index pass
    runs) launches, counts and writes zeros, on the long-run operands too;
    the whole kernel is unchanged by having run it. On a CPU tensor a
    knockout raises."""
    fn = spmm.windowed_segment_sum
    for ops in (_blocked_wss_operands(100), _long_run_operands(128, 100)):
        ops = _port(ops, cuda_device, dtype)
        full = fn(**ops)
        before = fn.launches
        out = fn(**ops, knockout=2)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert not out.any()
        assert torch.equal(fn(**ops), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=2)


def _row21_operands(window: int, hd: int, heads: int, slots: int, hot: bool,
                    seed: int = 30) -> dict:
    """Row 21's seeded operands over three windows of ``window`` rows, the
    last two-thirds real (its other rows padding), ``slots`` slots a row:
    each slot a random in-window source or empty (sentinel W), some sources
    on the last window's padding rows. Two rows of each window have no
    source and feed none; ``hot`` gives them scores of 100, past float32
    exp's overflow at 88.7, which their empty slots must keep out of their
    sums: the hot run equals the cold one."""
    rng = np.random.default_rng(seed + window + slots)
    nw = 3
    n = nw * window - window // 3
    stack = rng.integers(0, window, size=(nw, slots, window)).astype(np.int32)
    stack[rng.random(stack.shape) < 0.4] = window
    quiet = (window // 4, window // 2 + 1)  # rows with no source, read by none
    for q in quiet:
        stack[:, :, q] = window
        stack[stack == q] = window
    s_src = rng.normal(0, 1.0, (n, heads)).astype(np.float32)
    s_tgt = rng.normal(0, 1.0, (n, heads)).astype(np.float32)
    for w in range(nw):
        for q in quiet:
            if w * window + q < n:
                s_src[w * window + q] = s_tgt[w * window + q] = 100.0 if hot else 0.0
    return dict(slot_stack=stack.reshape(-1), h=rng.normal(0, 0.5, (n, hd)).astype(np.float32),
                s_src=s_src, s_tgt=s_tgt, window=window, slots=slots, num_heads=heads)


# Row 21's cases: W = 128, 512 and 1024 at (H·D, heads) on row 17's edges,
# the slot depth running through 1..8.
_ROW21_SHAPES = [(w, hd, heads) for w in (128, 512, 1024) for hd in (64, 128)
                 for heads in (1, 4, 32)]
_ROW21_CASES = [(w, hd, heads, 1 + i % 8) for i, (w, hd, heads) in enumerate(_ROW21_SHAPES)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,hd,heads,slots", _ROW21_CASES,
                         ids=[f"W{w}-{hd}x{h}-S{s}" for w, hd, h, s in _ROW21_CASES])
@pytest.mark.parametrize("divide", [True, False], ids=["divide", "sums"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row21_cuda_kernel_windows_match_plain(window, hd, heads, slots, divide, dtype, tol,
                                               cuda_device):
    """Row 21, row 17's message walk over slot rows, at W = 128, 512 and
    1024 (W/128 independent blocks a window), H·D = 64 and 128 with 1, 4
    and 32 heads (each of its walk shapes), 1 to 8 slots, divided and as
    raw sums, against its plain version; the rows whose empty slots hold
    overflowing scores stay finite and equal the cold run bit for bit.
    f32: summation order only; bf16: the output rounds once to bf16."""
    fn = local_layer.gat_local_message_slots
    before = fn.launches
    got = fn(**_port(_row21_operands(window, hd, heads, slots, False), cuda_device, dtype),
             divide=divide)
    hot = fn(**_port(_row21_operands(window, hd, heads, slots, True), cuda_device, dtype),
             divide=divide)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    expect = local_layer.gat_local_message_slots_ref(
        **_port(_row21_operands(window, hd, heads, slots, False), cuda_device, dtype),
        divide=divide)
    assert got.dtype == dtype and got.shape == expect.shape
    assert expect.abs().max() > 1e-2
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)
    assert bool(hot.isfinite().all())
    torch.testing.assert_close(hot, got, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("big,window", CLUSTER_WINDOWS, ids=[f"W{w}" for _, w in CLUSTER_WINDOWS])
@pytest.mark.parametrize("divide", [True, False], ids=["divide", "sums"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_row21_cuda_kernel_slot_layouts_match_plain(big, window, divide, dtype, tol, cuda_device):
    """Row 21 on GAT's own slot layouts at W = 128, 256, 512 and 1024 (the
    large graph's sources across the whole window), 4 heads × 16, against
    its plain version."""
    batch = _slot_batch_at("gat", big, window, 33)
    rng = np.random.default_rng(33)
    n = batch["node_feat"].shape[0]
    ops = _port(dict(slot_stack=batch["slot_stack"], h=rng.normal(0, 0.5, (n, 64)).astype(
        np.float32), s_src=rng.normal(0, 2.0, (n, 4)).astype(np.float32),
        s_tgt=rng.normal(0, 2.0, (n, 4)).astype(np.float32), window=window,
        slots=batch["slot_geom"].shape[-1], num_heads=4, divide=divide), cuda_device, dtype)
    got = local_layer.gat_local_message_slots(**ops)
    torch.cuda.synchronize()
    expect = local_layer.gat_local_message_slots_ref(**ops)
    assert got.dtype == dtype and got.shape == expect.shape
    scale = max(1.0, expect.abs().max().item())
    torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row21_knockout_launches(dtype, cuda_device):
    """The phase split's knockout of row 21 (bit 1: the messages) launches,
    counts and writes zero sums and quotients; the whole kernel is unchanged
    by having run it. On a CPU tensor a knockout raises."""
    fn = local_layer.gat_local_message_slots
    for divide in (True, False):
        ops = _port(_row21_operands(512, 64, 4, 6, False), cuda_device, dtype)
        full = fn(**ops, divide=divide)
        before = fn.launches
        out = fn(**ops, divide=divide, knockout=2)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and not bool(out.any())
        assert torch.equal(fn(**ops, divide=divide), full)
    with pytest.raises(ValueError, match="knockout"):
        fn(**{k: v.cpu() if torch.is_tensor(v) else v for k, v in ops.items()}, knockout=2)


@pytest.mark.cuda
def test_rows_15_21_cuda_kernels_reject_geometry(cuda_device):
    """Rows 15 and 21 raise before launch on what their kernels cannot
    take: a window that is not whole 128-row tiles (192) or spans more than
    8 (1152), row 15 an odd D or one past its tile (114 > 112), row 21 more
    than 32 heads or more than 8 slots."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    cases = []
    for window, d, match in ((192, 100, "whole blocks"), (1152, 100, "whole blocks"),
                             (128, 99, "even"), (128, 114, "tile")):
        n = 2 * window
        lanes = torch.full((2 * 8, 5), window, dtype=torch.int32, device=cuda_device)
        cases.append(("gcn_local_layer_ell", dict(
            ell_meta=lanes, h=t(n, d), dis=t(n), ee_table=t(13, d), root=t(d), alpha=t(d),
            beta=t(d), w_next=t(d, d), b_next=t(d), window=window), match))
    for window, heads, slots, match in ((192, 4, 4, "whole blocks"), (1152, 4, 4, "whole blocks"),
                                        (128, 64, 4, "num_heads"), (128, 4, 9, "slots")):
        n = 2 * window
        stack = torch.full((2 * slots * window,), window, dtype=torch.int32, device=cuda_device)
        cases.append(("gat_local_message_slots", dict(
            slot_stack=stack, h=t(n, 128), s_src=t(n, heads), s_tgt=t(n, heads), window=window,
            slots=slots, num_heads=heads), match))
    for kernel, kw, match in cases:
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(**kw)
        assert fn.launches == before


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
# The cluster cases: each form's full, nogather and noglue (where it has it)
# at W = 256 and 512.
_ABL_WIDE = [(w, f, v) for w in (256, 512) for f, (names, _) in ablate_gat_mega.FORMS.items()
             for v in ("full", "nogather", "noglue") if v in names]


def _ablation_against_plain(form, variant, dtype, tol, window, device):
    ops = _port(_ablation_call(form, _ablation_operands(positive=variant == "noexp",
                                                        window=window), window), device, dtype)
    before = ablate_gat_mega.gat_mega_ablate.launches
    got = ablate_gat_mega.gat_mega_ablate(form, variant, **ops)
    torch.cuda.synchronize()
    assert ablate_gat_mega.gat_mega_ablate.launches == before + 1
    want = ablate_gat_mega.gat_mega_ablate_ref(form, variant, **ops)
    assert bool(got.isfinite().all()) and want.abs().max() > 1e-2
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form,variant", _ABL_PAIRS, ids=[f"{f}-{v}" for f, v in _ABL_PAIRS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gat_mega_ablate_cuda_kernel_matches_plain(form, variant, dtype, tol, cuda_device):
    """Every (form, variant) of rows 27-30 against its plain version, one
    launch each. f32: summation order only; bf16: a rounding flip at one
    stage propagates through the later layer. ``noexp`` on nonnegative
    operands (``_ablation_operands``)."""
    _ablation_against_plain(form, variant, dtype, tol, ABL_W, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("window,form,variant", _ABL_WIDE,
                         ids=[f"w{w}-{f}-{v}" for w, f, v in _ABL_WIDE])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gat_mega_ablate_cuda_cluster_matches_plain(window, form, variant, dtype, tol,
                                                    cuda_device):
    """Each form's full, nogather and noglue on clusters of W/128 blocks
    (remote sources, v4's remote payload chunks, nogather's lanes i mod W in
    another block) against the plain version, as at W=128."""
    _ablation_against_plain(form, variant, dtype, tol, window, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("form,window", [
    *(pytest.param(f, None, id=f) for f in ablate_gat_mega.FORMS),
    *(pytest.param(f, 512, id=f"w512-{f}") for f in ablate_gat_mega.FORMS),
])
def test_gat_mega_ablate_cuda_full_width(form, window, cuda_device):
    """Each form's ``full`` at full width (4 heads × 16, L=5) on a 256-graph
    molhiv bucket (at W=128, and on clusters of four at W=512), f32: against
    its plain version and against row 5's kernel, 1e-4 (summation order, and
    v3-v5's composed score maps)."""
    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import gat
    from flowgnn_tpu_torch.params import loaders

    batch = ablate_gat_mega.molhiv_bucket(256, window, cuda_device)
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
@pytest.mark.parametrize("form", list(ablate_gat_mega.FORMS))
def test_gat_mega_ablate_cuda_occupancy(form, cuda_device):
    """At full width (H·D = 64, 4 heads) each bf16 form keeps the blocks an
    SM it is built for (``gma_blocks_per_sm``: two for v1 and v3, as row 5),
    at W = 128 and on clusters of eight at W = 1024."""
    built = ablate_gat_mega._library()["blocks_per_sm"](ablate_gat_mega.FORM_CODES[form])
    assert built == {"v1": 2, "v3": 2, "v4": 1, "v5": 1}[form]
    for window in (128, 1024):
        occ = ablate_gat_mega.occupancy(form, torch.bfloat16, window, 64, 4, base.POOL_GMAX, 1,
                                        cuda_device)
        assert occ["stages"] >= 2 and occ["clusters"] >= 1
        assert occ["blocks_per_sm"] == built, occ


@pytest.mark.cuda
def test_gat_mega_ablate_cuda_kernel_rejects(cuda_device):
    """A wrong dtype, a non-contiguous operand, a window that is not whole
    blocks of 128 rows or is past 1024, nopool past the window's rows:
    raises before launch."""
    fn = ablate_gat_mega.gat_mega_ablate
    ops = _port(_ablation_call("v3", _ablation_operands()), cuda_device)
    most = ablate_gat_mega._library()["max_window"]()
    assert most == 1024
    cases = [
        (dict(ops, h0=ops["h0"].double()), "full", TypeError),
        (dict(ops, x0=ops["x0"].T.contiguous().T), "full", ValueError),
        (dict(ops, window=192), "full", ValueError),
        (dict(ops, window=most + 128), "full", ValueError),
        (dict(ops, gmax=ABL_W + 1), "nopool", ValueError),
        (dict(ops, stack=ops["stack"].float()), "full", TypeError),
    ]
    before = fn.launches
    for kw, variant, err in cases:
        with pytest.raises(err):
            fn("v3", variant, **kw)
    assert fn.launches == before


def _gin_message_operands(kernel: str, geometry: str, d: int, spill: bool = True) -> dict:
    """Row 31's (``gin_local_message_ell``) or row 12's pass-through
    (``gin_local_message_ell_lanes``: seeded per-lane ``ee``, and
    ``m_spill`` unless ``spill`` is False) operands at width ``d`` on the
    layout of ``_ell_layer_batch``, as numpy arrays."""
    ops = _ell_layer_operands("gin_local_layer_ell", geometry, d=d)
    if kernel == "gin_local_message_ell":
        return {k: ops[k] for k in ("ell_meta", "ee_table", "h", "window")}
    rng = np.random.default_rng(23)
    ee = rng.normal(0, 0.2, (ops["ell_meta"].shape[0], d)).astype(np.float32)
    return dict(ee=ee, ell_meta=ops["ell_meta"], h=ops["h"],
                m_spill=ops["m_spill"] if spill else None, window=ops["window"])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gin_local_message_ell", "gin_local_message_ell_lanes"],
                         ids=["row31", "row12-pass-through"])
@pytest.mark.parametrize("geometry", list(ELL_LAYER_GEOMETRY))
@pytest.mark.parametrize("d", [100, 37])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_gin_message_cuda_kernels_match_plain(kernel, geometry, d, dtype, tol, cuda_device):
    """Row 31 and row 12's pass-through (the messages-only forms of
    ``csrc/gin_layer.cuh``) against their plain versions at W=128, W=512 and
    k=2, at the stage bench's D=100 and at an odd D, one launch per call;
    the pass-through with and without ``m_spill``. f32: summation order
    only; bf16: the output rounds once, so a sum near a rounding boundary
    lands one bf16 ulp of its scale apart."""
    fn = getattr(local_layer, kernel)
    for spill in ((True, False) if kernel.endswith("lanes") else (True,)):
        ops = _port(_gin_message_operands(kernel, geometry, d, spill), cuda_device, dtype)
        before = fn.launches
        got = fn(**ops)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        expect = getattr(local_layer, f"{kernel}_ref")(**ops)
        assert got.dtype == dtype and got.shape == expect.shape
        scale = max(1e-2, expect.abs().max().item())
        torch.testing.assert_close(got.float() / scale, expect.float() / scale, rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_gin_message_cuda_kernels_occupancy_and_rejects(cuda_device):
    """The messages-only forms' blocks hold no act tile and no ring (under 6
    KB at D=100), so more of them fit an SM than row 13's; a window that is
    not whole 128-row tiles, a D past 128 or a wrong dtype raises before
    launch."""
    row13 = local_layer.layer_occupancy("gin_local_layer_ell", torch.bfloat16, W,
                                        (100, 200, 13), cuda_device)
    for kernel, geometry in (("gin_local_message_ell", (100, 13)),
                             ("gin_local_message_lanes", (100,))):
        for dtype in (torch.float32, torch.bfloat16):
            occ = local_layer.layer_occupancy(kernel, dtype, W, geometry, cuda_device)
            assert occ["smem"] < 6 * 1024 and occ["stages"] == 0
            assert occ["blocks_per_sm"] > row13["blocks_per_sm"], (occ, row13)
    ops = _port(_gin_message_operands("gin_local_message_ell", "W128", 100), cuda_device)
    fn = local_layer.gin_local_message_ell
    before = fn.launches
    for kw, err in ((dict(window=192), ValueError), (dict(h=ops["h"].double()), TypeError),
                    (dict(h=torch.zeros(ops["h"].shape[0], 130, device=cuda_device),
                          ee_table=torch.zeros(13, 130, device=cuda_device)), ValueError)):
        with pytest.raises(err):
            fn(**dict(ops, **kw))
    assert fn.launches == before


def _stream_params(name: str, seed: int) -> dict:
    """Small seeded weights for the stream's card tests (D=32, H=64, L=2;
    GAT 2 heads × 16)."""
    from flowgnn_tpu_torch.params import loaders

    kind = name.split("-")[0]
    kw = dict(dim=D, layers=L)
    if kind == "gin":
        kw["hidden"] = H
    if kind == "gat":
        kw = dict(dim=GAT_D, heads=GAT_HEADS, layers=L)
    return getattr(loaders, f"synthetic_{kind}_params")(seed, **kw)


def _stream_eager(stream, items) -> np.ndarray:
    """Each bucket's eager forward on the card, in submission order."""
    out = []
    for bucket, sid in stream._bucketize(items):
        batch, n = stream._make_batch(bucket)
        pred = stream.spec.forward(stream.params[sid], base.to_device(batch, stream.device),
                                   stream.prec)
        out.append(pred[:n, 0].float().cpu().numpy())
    return np.concatenate(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn", "pna", "dgn", "gat"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_stream_cuda_replays_match_eager(name, dtype, tol, cuda_device):
    """``runtime.stream.InferenceStream`` on the card: 48 graphs in buckets
    of 8, weight sets flipped halfway; one CUDA graph per (signature, weight
    set), each replayed for buckets of other content, their predictions
    against each bucket's eager forward; the whole-model kernel launched
    only at the captures (an eager pass and the capture each), none by
    ``run_pipelined``, which equals ``run``."""
    from flowgnn_tpu_torch.core.numerics import Precision
    from flowgnn_tpu_torch.runtime.stream import InferenceStream

    prec = Precision(compute_dtype=dtype)
    stream = InferenceStream(name, [_stream_params(name, 0), _stream_params(name, 1)], prec,
                             node_capacity=511, edge_capacity=2048, graph_capacity=8,
                             device=cuda_device)
    items = [(g, i // 24) for i, g in enumerate(synthetic_molhiv(48, seed=4))]
    for bucket, _ in stream._bucketize(items):
        stream._make_batch(bucket)
    kernel = {"gin": "gin_local_model_slots", "gin-vn": "gin_local_model_slots",
              "gcn": "gcn_local_model_slots", "pna": "pna_local_model",
              "dgn": "dgn_local_model", "gat": "gat_local_model_slots"}[name]
    fn = getattr(local_layer, kernel)
    before = fn.launches
    got = np.array(list(stream.run(items)))
    assert fn.launches - before == 2 * len(stream.captured())
    assert len(stream.last_buckets) == 6 > len(set(stream.last_buckets))
    before = fn.launches
    pipe = np.array(list(stream.run_pipelined(items, depth=2, chain=3, workers=3)))
    assert fn.launches == before
    np.testing.assert_array_equal(pipe, got)
    want = _stream_eager(stream, items)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_stream_cuda_more_weight_sets_than_the_chunk_cache(cuda_device):
    """GIN in bf16 over ``MLP_TILE_SETS`` + 2 weight sets, one bucket each,
    run twice: the cache has evicted the first sets' weight chunks by the
    second run, whose replays still read them (the stream holds them) and
    equal the first run and each bucket's eager forward."""
    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.runtime.stream import InferenceStream

    n_sets = local_layer.MLP_TILE_SETS + 2
    stream = InferenceStream("gin", [_stream_params("gin", s) for s in range(n_sets)], BF16,
                             node_capacity=511, edge_capacity=2048, graph_capacity=8,
                             device=cuda_device)
    items = [(g, i // 8) for i, g in enumerate(synthetic_molhiv(8 * n_sets, seed=6))]
    first = np.array(list(stream.run(items)))
    assert len({s for _, s in stream.captured()}) == n_sets
    torch.cuda.empty_cache()
    again = np.array(list(stream.run(items)))
    np.testing.assert_array_equal(again, first)
    want = _stream_eager(stream, items)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(again / scale, want / scale, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_stream_cuda_capture_failure_raises(cuda_device):
    """A forward that cannot be captured (here: it reads a value back to the
    host) raises, naming the model and the signature; no eager fallback."""
    import dataclasses

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.runtime.stream import InferenceStream

    stream = InferenceStream("gcn", [_stream_params("gcn", 0)], FLOAT32, node_capacity=511,
                             edge_capacity=2048, graph_capacity=8, device=cuda_device)
    forward = stream.spec.forward

    def syncing(params, batch, prec):
        if batch["n_node"].sum().item() < 0:
            raise AssertionError
        return forward(params, batch, prec)

    stream.spec = dataclasses.replace(stream.spec, forward=syncing)
    with pytest.raises(RuntimeError, match="gcn local_slots W=128.*cannot be captured"):
        list(stream.run([(g, 0) for g in synthetic_molhiv(4, seed=1)]))


_WHOLE_MODEL = {"gin": "gin_local_model_slots", "gin-vn": "gin_local_model_slots",
                "gcn": "gcn_local_model_slots", "pna": "pna_local_model",
                "dgn": "dgn_local_model", "gat": "gat_local_model_slots"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_cli_run_case_cuda(name, dtype, tol, cuda_device, tmp_path):
    """``cli.run_case`` on the card over a 257-graph molhiv stream (the
    default layout policy: slots, W=128): the whole-model kernel launched
    once a bucket and pass (the warm pass and two trials) and no other
    kernel counted; each written prediction held to the plain edge-list path
    in f32 on the card (bf16: 1.5x what the bf16 plain path needs where
    larger, as ``chip_smoke.py`` gates it)."""
    from flowgnn_tpu_torch import cli
    from flowgnn_tpu_torch.core.graphs import pack_dataset
    from flowgnn_tpu_torch.core.numerics import FLOAT32, Precision

    prec = Precision(compute_dtype=dtype)
    fn = getattr(local_layer, _WHOLE_MODEL[name])
    before = fn.launches
    r = cli.run_case(name, "synth", 2, str(tmp_path), prec, num_graphs=257, caps=(2047, 8192, 64),
                     device=cuda_device)
    assert r["layout"] == "local_slots" and fn.launches - before == 3 * r["buckets"] > 3
    lines = (tmp_path / f"{name}_output.txt").read_text().splitlines()
    got = np.array([float(ln.split(": ")[1]) for ln in lines])
    assert [ln.split(":")[0] for ln in lines] == [f"g{i}" for i in range(1, 258)]
    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(257, seed=0))
    buckets = list(pack_dataset(graphs, 2047, 8192, 64, with_eigen=spec.needs_eigen))
    outs = {}
    for pr in (FLOAT32, prec):
        p = cli._params(name, pr, cuda_device, "synthetic", None, 0)
        outs[pr.compute_dtype] = np.concatenate([
            spec.forward(p, base.to_device(base.as_batch(b), cuda_device), pr)[
                : b.num_graphs, 0].float().cpu().numpy() for b in buckets])
    want = outs[torch.float32]
    scale = max(1.0, float(np.abs(want).max()))
    need = float((np.abs(outs[dtype] - want) / (scale + np.abs(want))).max())
    t = max(tol, 1.5 * need) if dtype == torch.bfloat16 else tol
    np.testing.assert_allclose(got / scale, want / scale, rtol=t, atol=t)


@pytest.mark.cuda
def test_profiling_trace_cuda(cuda_device, tmp_path):
    """``profiling.trace`` on the card writes a Chrome trace that holds the
    region's CUDA kernel among its device events."""
    import json
    import os

    from flowgnn_tpu_torch.bench import profiling

    x = torch.ones(256, 256, device=cuda_device)
    with profiling.trace(str(tmp_path), cuda_device):
        (x @ x).sum().item()
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events), {e.get("cat") for e in events}
