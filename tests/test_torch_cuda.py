"""The hand-written CUDA kernels against their plain torch versions, on a
card.

These tests skip without a CUDA device. The file imports no jax, so it runs
on a machine without it: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Its operand builders also serve ``test_torch_local_layer.py``.
"""

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_molhiv
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.ops import local_layer, spmm

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


def _ell_operands(name: str, big: int, seed: int = 16) -> dict:
    """Operands of the GIN / GIN-VN (``gin_local_model``) or GCN
    (``gcn_local_model``) ELL kernel: the ELL layout of ``_ell_batch``, the
    layout's own degree norms for GCN, seeded random h0 and weights, as
    numpy arrays."""
    batch = _ell_batch(name, big, seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
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


def _port(ops: dict, device, dtype=torch.float32) -> dict:
    out = {}
    for k, v in ops.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v).to(device)
            out[k] = t.to(dtype) if t.is_floating_point() and k != "eps_all" else t
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
    """A window whose state does not fit one block's shared memory raises
    before launch instead of failing inside the kernel."""
    d = 100
    n, window = 256, 256
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
    with pytest.raises(ValueError, match="shared memory"):
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
    """W=256 at the published widths (GCN D=100, PNA D=80) does not fit one
    block's shared memory: both wrappers raise before launch."""
    window, n = 256, 256
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    i32 = lambda *s, fill=0: torch.full(s, fill, dtype=torch.int32, device=cuda_device)
    d = 100
    gcn = dict(
        slot_meta=i32(window, 4, fill=-1), h0=t(n, d), dis=t(n), pool_gl=i32(window),
        ee_tables=t(L * 13, d), roots=t(L, d), alphas=t(L, d), betas=t(L, d),
        wn_all=t((L - 1) * d, d), bn_all=t(L - 1, d), pred_w=t(d, 1),
        window=window, slots=1, num_layers=L, gmax=base.POOL_GMAX, prefix_caps=(window,),
    )
    d = 80
    pna = dict(
        slot_src=i32(window, 1, fill=window), h0=t(n, d), inv_deg=t(n), t=t(n),
        scale=t(n), w_all=t(L * 4 * d, 3 * d), b_all=t(L, d), pool_gl=i32(window),
        mlp1_w=t(d, 40), window=window, slots=1, num_layers=L, gmax=base.POOL_GMAX,
        min_init=32.0, max_init=-32.0, prefix_caps=(window,),
    )
    for kernel, ops in (("gcn_local_model_slots", gcn), ("pna_local_model", pna)):
        fn = getattr(local_layer, kernel)
        before = fn.launches
        with pytest.raises(ValueError, match="shared memory"):
            fn(**ops)
        assert fn.launches == before


@pytest.mark.cuda
def test_dgn_gat_cuda_kernels_reject_oversized_window(cuda_device):
    """W=256 at the published widths (DGN D=100, GAT 4 × 16 with 7 full
    slots) does not fit one block's shared memory: both wrappers raise
    before launch."""
    window, n = 256, 256
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
        with pytest.raises(ValueError, match="shared memory"):
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
