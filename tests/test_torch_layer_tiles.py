"""The per-layer GIN kernels (rows 10, 12 and 25, ``csrc/gin_layer.cuh``),
GAT's fused ELL layer (row 23, ``csrc/gat_local_layer_ell.cu``), DGN's and
GCN's ELL layers (rows 18 and 15, the one-layer forms of
``csrc/dgn_model.cuh`` and ``csrc/gcn_model.cuh``) and GAT's slot messages
(row 21) on the host: row 23's packed skip and projection weights read back
as its kernel reads them, a plain mirror of its bf16 hi / lo projection, of
row 18's bf16 channels and posttrans and of row 15's bf16 messages and next
conv on the packed chunks against the plain versions and the JAX kernels in
interpret mode, the model's row-23 weights and the GIN layers' slice of
``mlp_tiles`` packed once per weight set, and the launch plans of rows 10,
12, 13, 15, 21, 23, 25, 14, 24, 16 and 19 worked out once per geometry."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import gat, gin
from flowgnn_tpu_torch.ops import local_layer, spmm
from flowgnn_tpu_torch.params.loaders import (
    params_from_numpy, synthetic_gat_params, synthetic_gin_params,
)
from test_torch_cuda import (
    ELL_LAYER_GEOMETRY, _dgn_gat_ell_operands, _ell_layer_operands, _gat_layer_operands, _port,
)
from test_torch_ell_dgn_gat import KEEP_F32
from test_torch_ell_dgn_gat import _jax_row as _jax_ell_row
from test_torch_gat_fused import ROW_CASES, ROW_IDS, _jax_row
from test_torch_ell_layer import _jax_operands
from test_torch_gin_slots import _bf16_stream
from test_torch_local_layer import _jax_kernel
from test_torch_tiles import _check_linear_chunk, _read

N = local_layer.GAT_LAYER_N


def _gat_weights(hd: int, layers: int, seed: int):
    rng = np.random.default_rng(seed)
    w = lambda: torch.from_numpy(rng.normal(0, 1, (layers, hd, hd)).astype(np.float32))
    return w(), w()


@pytest.mark.parametrize("hd", [64, 48, 32, 16])
def test_gat_layer_pack_reads_back(hd):
    """Row 23's bf16 chunks, per layer [K'/32 + 2K'/32, 32·64] (K' = H·D padded
    to 32): each skip chunk read through the product's descriptors is
    w_skipᵀ's 32 rows, each projection chunk [w_projᵀ; w_projᵀ]'s (the hi
    and the lo half of feat meet the same weights), pads zero; the f32 form
    [2, H·D, 64] is w_skipᵀ and w_projᵀ with zero columns; a stack packs as
    its layers do alone."""
    layers = 3
    w_skip, w_proj = _gat_weights(hd, layers, seed=hd)
    kp, skip_c, proj_c, elems = local_layer.gat_layer_geometry(hd)
    assert kp % 32 == 0 and kp - hd < 32 and proj_c == 2 * skip_c and elems == 32 * N
    bf = local_layer.gat_layer_pack(w_skip.bfloat16(), w_proj.bfloat16())
    assert bf.shape == (layers, skip_c + proj_c, elems) and bf.dtype == torch.bfloat16
    for l in range(layers):
        skip_t = torch.zeros(N, kp, dtype=torch.bfloat16)
        skip_t[:hd, :hd] = w_skip[l]
        proj_t = torch.zeros(N, 2 * kp, dtype=torch.bfloat16)
        proj_t[:hd, :hd] = w_proj[l]
        proj_t[:hd, kp : kp + hd] = w_proj[l]
        for c in range(skip_c):
            _check_linear_chunk(bf[l, c], skip_t, c, N)
        for c in range(proj_c):
            _check_linear_chunk(bf[l, skip_c + c], proj_t, c, N)
        one = local_layer.gat_layer_pack(w_skip[l : l + 1].bfloat16(),
                                         w_proj[l : l + 1].bfloat16())
        assert torch.equal(one[0], bf[l])
    f32 = local_layer.gat_layer_pack(w_skip, w_proj)
    assert f32.shape == (layers, 2, hd, N) and f32.dtype == torch.float32
    assert torch.equal(f32[:, 0, :, :hd], w_skip.transpose(1, 2))
    assert torch.equal(f32[:, 1, :, :hd], w_proj.transpose(1, 2))
    assert not f32[..., hd:].any()


def _hilo_mirror(ops: dict) -> tuple:
    """Row 23 as its bf16 kernel forms the projection, in plain torch: the
    sums, the skip product and the ELU as the plain version, then feat (f32)
    split into hi = bf16(feat) and lo = bf16(feat − hi), h_next = [hi | lo]
    · [w_projᵀ; w_projᵀ] in f32 (each product of two bf16 values exact in
    f32), feat's output column hi, the scores from the unrounded h_next.
    Returns (the output in bf16, feat, hi + lo)."""
    h, w_skip, w_proj, a_mat = ops["h"], ops["w_skip"], ops["w_proj"], ops["a_mat"]
    n, hd = h.shape
    heads = ops["num_heads"]
    tot = local_layer._gat_ell_sums(ops["ell_meta"], h, ops["s_src"], ops["s_tgt"],
                                    ops["window"], heads)
    if ops["spill_both"] is not None:
        tot = tot + local_layer._padded(ops["spill_both"].float(), tot.shape[0])
    den = tot[:, hd:]
    den = torch.where(den == 0, 1.0, den).repeat_interleave(hd // heads, dim=1)
    prev = local_layer._padded(ops["prev"], tot.shape[0]).float()
    x = tot[:, :hd] / den + prev @ w_skip.float().T
    feat = torch.where(x > 0, x, torch.exp(torch.clamp_max(x, 0.0)) - 1.0)
    hi = feat.bfloat16()
    lo = (feat - hi.float()).bfloat16()
    a = torch.cat([hi, lo], dim=1).float()
    b = torch.cat([w_proj.float().T, w_proj.float().T], dim=0)
    h_next = a @ b
    out = torch.cat([h_next, hi.float(), h_next @ a_mat.float()], dim=1)[:n].bfloat16()
    return out, feat, hi.float() + lo.float()


@pytest.mark.parametrize("geometry,spill", ROW_CASES, ids=ROW_IDS)
def test_gat_layer_hilo_projection_moves_no_rounding_point(geometry, spill, monkeypatch):
    """The bf16 kernel's hi / lo projection keeps feat in f32 into the
    product: hi + lo is feat to 2⁻¹⁶ of |feat| (lo's own rounding is 2⁻⁹ of
    feat − hi, itself 2⁻⁹ of feat), so the mirror's bf16 output equals the
    plain version's and the Pallas kernel's (interpret mode) where their
    f32 values round alike: > 99% bit-equal, the rest one bf16 ulp apart
    (rtol 2⁻⁷), as the plain version and the Pallas kernel are to each
    other (``test_gat_layer_ref_matches_jax_bf16``)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gat_layer_operands(geometry, spill)
    port = dict(_port(ops, "cpu", torch.bfloat16),
                **_port({k: ops[k] for k in ("s_src", "s_tgt")}, "cpu"))
    got, feat, hilo = _hilo_mirror(port)
    assert bool(((hilo - feat).abs() <= 2.0 ** -16 * feat.abs()).all())
    ref = local_layer.gat_local_layer_ell(**port)
    jax = _jax_row(ops, geometry, bf16=True)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape == jax.shape
    got, ref = got.float().numpy(), ref.float().numpy()
    for want in (ref, jax):
        assert (got == want).mean() > 0.99
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def _row18_mirror(ops: dict) -> torch.Tensor:
    """Row 18 as its bf16 kernel computes it, in plain torch: per window
    row, its lanes' [h_u | rnd(e_u·h_u)] summed in f32 in lane order (a lane
    whose u lies outside the window adds nothing), m2 = Σ − e_v·m1, the
    channels a = rnd([m1·invd | |m2 − ews·h|·inva]) padded to K' columns,
    the posttrans y = a·B with B read from ``dgn_layer_tiles``' chunks
    through the product's descriptors, chunk by chunk and K step by K step
    (each product of two bf16 values exact in f32), then rnd(h + relu(y +
    b)). Returns the next h in bf16."""
    h, meta, w = ops["h"], ops["ell_meta"].long(), ops["window"]
    n, d = h.shape
    nw = -(-n // w)
    rows = nw * w
    rnd = lambda x: x.bfloat16().float()
    col = lambda v: local_layer._padded(rnd(v.float())[:, None], rows)
    hf = local_layer._padded(h, rows).float()
    eig, invd, ews, inva = (col(ops[k]) for k in ("eig", "inv_deg", "eigw_sum", "inv_abssum"))
    lanes = meta.reshape(nw, -1, 5)
    m1 = torch.zeros(rows, d)
    m2 = torch.zeros(rows, d)
    base = torch.arange(nw) * w
    for j in range(lanes.shape[1]):  # lane j of every window, in lane order
        u, v = lanes[:, j, 0], lanes[:, j, 1]
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < w)
        src, dst = (base + u)[ok], (base + v)[ok]
        x = hf[src]
        m1[dst] += x
        m2[dst] += rnd(eig[src] * x)
    m2 = m2 - eig * m1
    n_out = local_layer.gcn_conv_n(d)
    kp, chunks, _ = local_layer.linear_geometry(2 * d, n_out)
    a = torch.zeros(rows, kp)
    a[:, :2 * d] = rnd(torch.cat([m1 * invd, (m2 - ews * hf).abs() * inva], dim=1))
    tiles = local_layer.dgn_layer_tiles(ops["w_post"])
    y = torch.zeros(rows, n_out)
    for c in range(chunks):
        for s in range(2):
            bt = _read(tiles[c], 2 * s * n_out * 16, n_out * 16, 128, n_out, 32).float()
            y += a[:, 32 * c + 16 * s : 32 * c + 16 * s + 16] @ bt.T
    y = y[:, :d] + ops["b_post"].float()
    return (hf + torch.clamp_min(y, 0.0)).bfloat16()[:n]


@pytest.mark.parametrize("geometry", ["W128", "k2"])
def test_dgn_layer_ell_bf16_product_moves_no_rounding_point(geometry, monkeypatch):
    """Row 18's bf16 kernel (channels summed in lane order with each lane's
    e_u·h_u rounded, the posttrans on the packed chunks) mirrored in plain
    torch equals the plain version and the Pallas kernel (interpret mode)
    where their f32 values round alike: > 99% bit-equal, the rest one bf16
    ulp apart (rtol 2⁻⁷), as the plain version and the Pallas kernel are to
    each other (``test_new_rows_ref_match_jax_bf16``)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _dgn_gat_ell_operands("dgn_local_layer_ell", geometry)
    port = dict(_port(ops, "cpu", torch.bfloat16),
                **_port({k: v for k, v in ops.items() if k in KEEP_F32}, "cpu"))
    got = _row18_mirror(port)
    ref = local_layer.dgn_local_layer_ell(**port)
    jax = _jax_ell_row("dgn_local_layer_ell", ops, geometry, bf16=True)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape == jax.shape
    got, ref = got.float().numpy(), ref.float().numpy()
    assert np.abs(ref).max() > 1e-2
    for want in (ref, jax):
        assert (got == want).mean() > 0.99
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def _row15_mirror(ops: dict) -> torch.Tensor:
    """Row 15 as its bf16 kernel computes it on a non-final layer, in plain
    torch: per window row, its lanes' rnd(dis_u·relu(h_u + ee)) summed in
    f32 in lane order (ee the lane's table rows summed in order; a lane
    whose u lies outside the window or on a padding row has dis_u = 0), the
    tail a = acc·dis_v + relu(h_v + root)·dis_v², x = alpha·a + beta, the
    conv input rnd(relu(x)) padded to K' columns, the next conv y = x·B with
    B read from ``gcn_layer_tiles``' chunks through the product's
    descriptors, chunk by chunk and K step by K step (each product of two
    bf16 values exact in f32), then rnd(y + b_next). Returns h' in bf16."""
    h, meta, w = ops["h"], ops["ell_meta"].long(), ops["window"]
    n, d = h.shape
    nw = -(-n // w)
    rows = nw * w
    rnd = lambda x: x.bfloat16().float()
    hf = local_layer._padded(h, rows).float()
    dis = local_layer._padded(ops["dis"].float()[:, None], rows)
    tab = ops["ee_table"].float()
    lanes = meta.reshape(nw, -1, 5)
    acc = torch.zeros(rows, d)
    base = torch.arange(nw) * w
    for j in range(lanes.shape[1]):  # lane j of every window, in lane order
        u, v = lanes[:, j, 0], lanes[:, j, 1]
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < w)
        src, dst = (base + u)[ok], (base + v)[ok]
        ee = torch.zeros(len(src), d)
        for a in lanes[:, j, 2:][ok].T:  # the three bond rows, in order
            ee = ee + torch.where(((a >= 0) & (a < tab.shape[0]))[:, None],
                                  tab[a.clamp(0, tab.shape[0] - 1)], 0.0)
        acc[dst] += rnd(dis[src] * torch.clamp_min(hf[src] + ee, 0.0))
    root = torch.clamp_min(hf + ops["root"].float(), 0.0)
    a = acc * dis + root * (dis * dis)
    x = ops["alpha"].float() * a + ops["beta"].float()
    n_out = local_layer.gcn_conv_n(d)
    kp, chunks, _ = local_layer.linear_geometry(d, n_out)
    xin = torch.zeros(rows, kp)
    xin[:, :d] = rnd(torch.clamp_min(x, 0.0))
    tiles = local_layer.gcn_layer_tiles(ops["w_next"])
    y = torch.zeros(rows, n_out)
    for c in range(chunks):
        for s in range(2):
            bt = _read(tiles[c], 2 * s * n_out * 16, n_out * 16, 128, n_out, 32).float()
            y += xin[:, 32 * c + 16 * s : 32 * c + 16 * s + 16] @ bt.T
    return (y[:, :d] + ops["b_next"].float()).bfloat16()[:n]


@pytest.mark.parametrize("geometry", ["W128", "k2"])
def test_gcn_layer_ell_bf16_conv_moves_no_rounding_point(geometry, monkeypatch):
    """Row 15's bf16 kernel (messages rounded a lane and summed in lane
    order, the tail, the next conv on the packed chunks) mirrored in plain
    torch equals the plain version and the Pallas kernel (interpret mode)
    where their f32 values round alike: > 99% bit-equal, the rest one bf16
    ulp apart (rtol 2⁻⁷)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _ell_layer_operands("gcn_local_layer_ell", geometry)
    port = _port(ops, "cpu", torch.bfloat16)
    got = _row15_mirror(port)
    ref = local_layer.gcn_local_layer_ell(**port)
    jops = {k: jnp.asarray(v, jnp.bfloat16) if isinstance(v, np.ndarray) and v.dtype == np.float32
            else v for k, v in _jax_operands("gcn_local_layer_ell", ops,
                                             ELL_LAYER_GEOMETRY[geometry][2]).items()}
    jax = np.asarray(_jax_kernel("gcn_local_layer_ell", jops), np.float32)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape == jax.shape
    got, ref = got.float().numpy(), ref.float().numpy()
    assert np.abs(ref).max() > 1e-2
    for want in (ref, jax):
        assert (got == want).mean() > 0.99
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def test_gat_layer_tiles_are_the_model_slices_packed_once(monkeypatch):
    """Row 23's weights (``gat.layer_tiles``): one pack of layers 0..L−2 for
    a fused forward over several buckets, in f32 and in bf16; layer l's
    operands carry its slice, equal to the direct call's own pack of
    (skip_w[l], proj_w[l+1]); an in-place update of a weight packs again."""
    packs = []
    real = local_layer.gat_layer_pack

    def counted(w_skip, w_proj):
        packs.append(w_skip.shape[0])
        return real(w_skip, w_proj)

    monkeypatch.setattr(local_layer, "gat_layer_pack", counted)
    local_layer._MLP_TILES.clear()
    for prec in (tn.FLOAT32, tn.BF16):
        packs.clear()
        params = params_from_numpy(synthetic_gat_params(5, dim=16, heads=2, layers=3), prec,
                                   "cpu")
        ell = _bf16_stream("gat", "local_ell", 128, block=512)
        for b in ell:
            gat.forward(params, b, prec, fuse_layers=True)
        assert packs == [2]
        tiles = gat.layer_tiles(params, prec)
        ops = gat.layer_kernel_operands(params, ell[1], prec, fuse_layers=True)
        got = ops["gat_local_layer_ell"]["layer_tiles"]
        assert got.data_ptr() == tiles[0].data_ptr()
        hd = ops["gat_local_layer_ell"]["h"].shape[1]
        for l in range(2):
            own = real(params["skip_w"][l].reshape(1, hd, hd),
                       params["proj_w"][l + 1].reshape(1, hd, hd))
            assert torch.equal(tiles[l], own[0])
        assert packs == [2]
        with torch.no_grad():
            params["proj_w"][2].mul_(2)
        for b in ell:
            gat.forward(params, b, prec, fuse_layers=True)
        assert packs == [2, 2]
        assert not torch.equal(gat.layer_tiles(params, prec)[1], tiles[1])
    assert gat.layer_tiles(params_from_numpy(synthetic_gat_params(5, dim=16, heads=2, layers=3),
                                             tn.FLOAT64, "cpu"), tn.FLOAT64) is None


def test_block_layer_tiles_are_the_model_slices_packed_once(monkeypatch):
    """Rows 10, 12 and 25's bf16 weight chunks: their operands carry layer
    l's slice of ``gin.weight_tiles`` (one pack for forwards over legacy
    local and edge-block batches, fused, and row 12's operands on ELL
    batches), equal to one layer's own pack; a direct call's pack
    (``_mlp_operand`` without tiles) is made once per weight set; an
    in-place update of a weight packs again."""
    packs = []
    real = local_layer.gin_mlp_tiles

    def counted(w1_all, w2_all, num_layers):
        packs.append(num_layers)
        return real(w1_all, w2_all, num_layers)

    monkeypatch.setattr(local_layer, "gin_mlp_tiles", counted)
    local_layer._MLP_TILES.clear()
    params = params_from_numpy(synthetic_gin_params(5, dim=16, hidden=40, layers=3), tn.BF16,
                               "cpu")
    local = _bf16_stream("gin", "local", 128)
    blocked = _bf16_stream("gin", True, 128)
    ell = _bf16_stream("gin", "local_ell", 128, block=384)
    eps_all = gin.eps1_all(params, tn.BF16)

    def run_all():
        outs = [gin.forward(params, b, tn.BF16) for b in local]
        outs += [gin.forward(params, b, tn.BF16, fused=True) for b in blocked]
        return outs

    first = run_all()
    assert packs == [3]
    tiles = gin.weight_tiles(params, tn.BF16)
    h = tb.atom_embed(params["node_embedding"], local[0]["node_feat"], tn.BF16)
    ee = tb.bond_embed(params["edge_embedding"][0], local[0]["edge_attr"], tn.BF16)
    hb = tb.atom_embed(params["node_embedding"], blocked[0]["node_feat"], tn.BF16)
    msg = torch.relu(tb.gather_sources(hb, blocked[0]) + tb.bond_embed(
        params["edge_embedding"][0], blocked[0]["edge_attr"], tn.BF16))
    he = tb.atom_embed(params["node_embedding"], ell[0]["node_feat"], tn.BF16)
    for l in range(3):
        for ops in (gin._local_layer_operands(params, local[0], tn.BF16, l, h, ee, eps_all),
                    gin._fused_layer_operands(params, blocked[0], tn.BF16, l, hb, msg, eps_all),
                    gin.ell_layer_operands(params, ell[0], tn.BF16, l, he, tb.ell_meta(ell[0]),
                                           tb.ell_spill(ell[0]), eps_all, lane_ee=True)):
            assert ops["mlp_tiles"].data_ptr() == tiles[l].data_ptr()
        assert torch.equal(tiles[l], real(params["mlp1_w"][l], params["mlp2_w"][l], 1)[0])
    assert packs == [3]
    own = local_layer._mlp_operand(None, None, params["mlp1_w"][1], params["mlp2_w"][1], 1, True)
    assert local_layer._mlp_operand(None, None, params["mlp1_w"][1], params["mlp2_w"][1], 1,
                                    True).data_ptr() == own.data_ptr()
    assert packs == [3, 1] and torch.equal(own, tiles[1])
    assert gin._local_layer_operands(params_from_numpy(
        synthetic_gin_params(5, dim=16, hidden=40, layers=3), tn.FLOAT32, "cpu"), local[0],
        tn.FLOAT32, 0, h.float(), ee.float(), eps_all)["mlp_tiles"] is None

    with torch.no_grad():
        params["mlp1_w"][2].mul_(2)
    again = run_all()
    assert packs == [3, 1, 3]
    assert not torch.equal(gin.weight_tiles(params, tn.BF16)[2], tiles[2])
    assert any(not torch.equal(a, b) for a, b in zip(first, again))


class _FakeLibrary(dict):
    """A per-layer library's getters, counting each call: what a plan reads
    from the card (a 227 KB opt-in limit, 228 KB an SM) and its kernels'
    shared memory (50 KB and 1 KB a ring buffer)."""

    def __init__(self, calls: collections.Counter, prepared: list):
        def getter(key, value):
            def f(*args):
                calls[key] += 1
                return value(*args) if callable(value) else value
            return f

        def mlp_dims(d, hid, dims):
            dp, hp, n2, _, elems = local_layer.gin_mlp_geometry(d, hid)
            dims[0:4] = (dp, hp, n2, 2 * elems)

        def tile_dims(hd, dims):
            kp, skip_c, proj_c, elems = local_layer.gat_layer_geometry(hd)
            dims[0:4] = (kp, skip_c, proj_c, 2 * elems)

        def conv_dims(d, dims):
            n = local_layer.gcn_conv_n(d)
            kp, _, elems = local_layer.linear_geometry(d, n)
            dims[0:3] = (kp, n, 2 * elems)

        def prepare(smem, device):
            prepared.append(smem)
            return 0

        super().__init__(
            max_d=getter("max_d", 112), rows_per_block=getter("rows_per_block", 128),
            max_window_blocks=getter("max_window_blocks", 8), max_heads=getter("max_heads", 32),
            max_slots=getter("max_slots", 8), conv_dims=getter("conv_dims", conv_dims),
            smem_optin=getter("smem_optin", 232448), smem_per_sm=getter("smem_per_sm", 233472),
            smem_bytes=getter("smem_bytes", lambda *a: 50000 + 1000 * a[-1]),
            mlp_dims=getter("mlp_dims", mlp_dims), tile_dims=getter("tile_dims", tile_dims),
            prepare=getter("prepare", prepare), error_string=lambda rc: b"fake",
        )


def test_layer_launch_plans_are_worked_out_once_per_geometry(monkeypatch):
    """The launch plans of rows 13, 10 / 12, 25 (``_gin_layer_plan``), 23
    (``_gat_layer_plan``), 15 (``_layer_plan``) and 21
    (``_gat_message_plan``) read the library's getters once per (dtype,
    widths, window, device), not once per launch, and opt the kernels in to
    their shared memory only when a plan needs more than any before (so
    every cached plan stays valid); a geometry the kernel refuses raises
    each time and is not cached."""
    calls, prepared = collections.Counter(), []
    libs = {name: _FakeLibrary(calls, prepared)
            for name in (*local_layer.GIN_LAYER_LIBRARIES, "gat_local_layer_ell",
                         "gcn_local_layer_ell", "gat_local_message_slots")}
    monkeypatch.setattr(local_layer, "_library", libs.__getitem__)
    monkeypatch.setattr(local_layer, "_PREPARED", {})
    plans = (local_layer._gin_layer_plan, local_layer._gat_layer_plan, local_layer._layer_plan,
             local_layer._gat_message_plan)
    for plan in plans:
        plan.cache_clear()
    try:
        gin_plan = lambda name, code, hid, window: local_layer._gin_layer_plan(
            name, code, 100, hid, 13 if name == "gin_local_layer_ell" else 0, window, 0)
        for name in local_layer.GIN_LAYER_LIBRARIES:
            calls.clear()
            prepared.clear()
            first = gin_plan(name, 1, 200, 128)
            assert first == (7, 57000)  # all 7 chunks of H=200 fit two blocks an SM
            reads = sum(calls.values())
            assert reads > 0 and prepared == [57000]
            for _ in range(3):
                assert gin_plan(name, 1, 200, 128) == first
            assert sum(calls.values()) == reads
            assert gin_plan(name, 0, 200, 128) == (0, 50000)  # f32: no ring, no new opt-in
            assert gin_plan(name, 1, 512, 1024) == (16, 66000)  # H=512: 16 chunks
            assert prepared == [57000, 66000]
            for _ in range(2):
                with pytest.raises(ValueError, match="whole blocks"):
                    gin_plan(name, 1, 200, 192)
        calls.clear()
        prepared.clear()
        assert local_layer._gat_layer_plan(1, 64, 4, 128, 0) == (6, 56000)  # 2 + 4 chunks
        reads = sum(calls.values())
        assert local_layer._gat_layer_plan(1, 64, 4, 128, 0) == (6, 56000)
        assert local_layer._gat_layer_plan(0, 64, 4, 1024, 0) == (0, 50000)
        assert sum(calls.values()) > reads and prepared == [56000]
        reads = sum(calls.values())
        local_layer._gat_layer_plan(0, 64, 4, 1024, 0)
        assert sum(calls.values()) == reads
        with pytest.raises(ValueError, match="num_heads"):
            local_layer._gat_layer_plan(1, 64, 64, 128, 0)

        # Row 15: the bf16 ring takes all 4 chunks of D=100 within two blocks an SM.
        calls.clear()
        prepared.clear()
        row15 = lambda code, d, window: local_layer._layer_plan("gcn_local_layer_ell", code, d, 0,
                                                                window, 0, 13)
        assert row15(1, 100, 512) == (4, 54000)
        reads = sum(calls.values())
        assert reads > 0 and calls["conv_dims"] == 1
        for _ in range(3):
            assert row15(1, 100, 512) == (4, 54000)
        assert sum(calls.values()) == reads
        assert row15(0, 100, 512) == (0, 50000)  # f32: no ring
        for _ in range(2):
            with pytest.raises(ValueError, match="whole blocks"):
                row15(1, 100, 1152)
            with pytest.raises(ValueError, match="even"):
                row15(0, 99, 128)
        # Row 21: no shared memory beyond the fake's; refusals each time.
        calls.clear()
        row21 = lambda heads, slots, window: local_layer._gat_message_plan(64, heads, slots, window,
                                                                           0)
        first = row21(4, 8, 1024)
        reads = sum(calls.values())
        assert reads > 0 and calls["max_slots"] == 1
        for _ in range(3):
            assert row21(4, 8, 1024) == first
        assert sum(calls.values()) == reads
        for _ in range(2):
            with pytest.raises(ValueError, match="slots"):
                row21(4, 9, 128)
            with pytest.raises(ValueError, match="num_heads"):
                row21(64, 4, 128)
        assert prepared == []  # neither opts in: rows 15 and 21 need no prepare
    finally:
        for plan in plans:
            plan.cache_clear()


def test_row14_row24_launch_plans_are_worked_out_once_per_geometry(monkeypatch):
    """Row 14's plan (``_layer_plan``: messages only, no product and no
    ring) and row 24's (``spmm._wss_plan``: the vector a thread moves and
    the threads a row) read the library's getters once per geometry, not
    once per launch. Row 24's
    vector is the widest of 16, 8, 4 and (bf16) 2 bytes that divides a row's
    bytes and the pointers' alignment, and a row of at most 16 vectors takes
    a half-warp. A geometry a kernel refuses raises each time and is not
    cached."""
    calls, prepared = collections.Counter(), []
    row14, wss = _FakeLibrary(calls, prepared), _FakeLibrary(calls, prepared)

    def counted(key, value):
        def f(*args):
            calls[key] += 1
            return value
        return f

    row14["max_d"] = counted("max_d", 128)
    del wss["max_d"]  # row 24 takes any width
    wss["smem_bytes"] = counted("smem_bytes", 33868)
    monkeypatch.setattr(local_layer, "_library", {"gcn_local_message_ell": row14}.__getitem__)
    monkeypatch.setattr(spmm, "_library", {"windowed_segment_sum": wss}.__getitem__)
    plans = (local_layer._layer_plan, spmm._wss_plan)
    for plan in plans:
        plan.cache_clear()
    try:
        row14_plan = lambda code, d, window: local_layer._layer_plan(
            "gcn_local_message_ell", code, d, 0, window, 0, 13)
        assert row14_plan(1, 100, 128) == (0, 63000)  # the fake's 50 KB + 1 KB a table row
        reads = sum(calls.values())
        assert reads > 0 and calls["max_d"] >= 1
        for _ in range(3):
            assert row14_plan(1, 100, 128) == (0, 63000)
        assert sum(calls.values()) == reads
        assert row14_plan(0, 37, 1024) == (0, 63000)  # an odd D: no even-D tile here
        for _ in range(2):
            with pytest.raises(ValueError, match="tile"):
                row14_plan(1, 129, 128)
            with pytest.raises(ValueError, match="whole blocks"):
                row14_plan(1, 100, 1152)
        assert prepared == []  # row 14 needs no prepare

        calls.clear()
        row24_plan = lambda code, d, window, align=16: spmm._wss_plan(code, d, window, align, 0)
        assert row24_plan(1, 100, 128) == (8, 32)  # bf16 D'=100: 200-byte rows, 25 vectors
        reads = sum(calls.values())
        assert reads > 0
        for _ in range(3):
            assert row24_plan(1, 100, 128) == (8, 32)
        assert sum(calls.values()) == reads
        for code, d, window, align, want in (
            (1, 200, 128, 16, (16, 32)), (0, 200, 512, 16, (16, 32)), (1, 68, 128, 16, (8, 32)),
            (1, 160, 128, 16, (16, 32)), (0, 40, 512, 16, (16, 16)), (1, 37, 128, 16, (2, 32)),
            (0, 37, 300, 16, (4, 32)), (0, 200, 128, 4, (4, 32)), (1, 200, 128, 2, (2, 32)),
            (1, 1, 1, 16, (2, 16)),
        ):
            assert row24_plan(code, d, window, align) == want, (code, d, window, align)
        wss["smem_optin"] = counted("smem_optin", 1000)
        for _ in range(2):
            with pytest.raises(ValueError, match="shared memory"):
                row24_plan(0, 100, 256)
        base = torch.zeros(64, dtype=torch.bfloat16)
        assert spmm._alignment(base) == 16
        assert spmm._alignment(base[1:]) == 2 and spmm._alignment(base[2:], base) == 4
    finally:
        for plan in plans:
            plan.cache_clear()


def test_row16_row19_launch_plans_are_worked_out_once_per_geometry(monkeypatch):
    """Rows 16 and 19's plans (``_layer_plan``: the channels- and stats-only
    forms, no product and no ring; row 19's keyed by its slots too) read the
    library's getters once per geometry, not once per launch: the carve-up
    is the library's ``_smem_bytes`` at the launch's dtype, width (and row
    19's slots), and ``occupancy`` hands the calculator that geometry (row
    19 at its deepest slot table). A geometry a kernel refuses (a D past 128,
    a window past 8 blocks, more than 8 slots) raises each time and is not
    cached; neither kernel opts in through ``_prepare``."""
    calls, prepared, asked = collections.Counter(), [], []
    libs = {"dgn_local_layer_ell": _FakeLibrary(calls, prepared),
            "pna_local_stats_slots": _FakeLibrary(calls, prepared)}

    def counted(key, value):
        def f(*args):
            calls[key] += 1
            return value(*args)
        return f

    def occupancy(*args):
        asked.append(args[:-2])
        args[-1][0], args[-1][1] = 2, 33
        return 0

    for lib in libs.values():
        lib["max_d"] = counted("max_d", lambda: 128)
        lib["smem_bytes"] = counted("smem_bytes", lambda code, d, *slots: 1000 * (code + 1) + d
                                    + 10000 * sum(slots))
        lib["occupancy"] = occupancy
    monkeypatch.setattr(local_layer, "_library", libs.__getitem__)
    local_layer._layer_plan.cache_clear()
    try:
        row16 = lambda code, d, window: local_layer._layer_plan("dgn_local_layer_ell", code, d, 0,
                                                                window, 0)
        row19 = lambda code, d, slots, window: local_layer._layer_plan(
            "pna_local_stats_slots", code, d, slots, window, 0)
        assert row16(1, 100, 128) == (0, 2100)
        assert row19(1, 80, 8, 128) == (0, 82080)
        reads = sum(calls.values())
        assert calls["max_d"] >= 2 and calls["smem_bytes"] == 2
        for _ in range(3):
            assert row16(1, 100, 128) == (0, 2100)
            assert row19(1, 80, 8, 128) == (0, 82080)
        assert sum(calls.values()) == reads
        assert row16(0, 37, 1024) == (0, 1037)  # f32, an odd D
        assert row19(0, 80, 1, 384) == (0, 11080)  # one slot: a plan of its own
        for _ in range(2):
            with pytest.raises(ValueError, match="tile"):
                row16(1, 129, 128)
            with pytest.raises(ValueError, match="whole blocks"):
                row19(1, 80, 8, 1152)
            with pytest.raises(ValueError, match="slots"):
                row19(1, 80, 9, 128)
        occ = local_layer.occupancy("pna_local_stats_slots", torch.bfloat16, 512, (80,), 0, 0,
                                    torch.device("cuda", 0))
        assert occ == dict(smem=82080, stages=0, blocks_per_sm=2, clusters=33)
        local_layer.occupancy("dgn_local_layer_ell", torch.float32, 256, (100,), 0, 0,
                              torch.device("cuda", 0))
        assert asked == [(1, 512, 80, 8), (0, 256, 100)]
        assert prepared == []
    finally:
        local_layer._layer_plan.cache_clear()
