"""The port's bench kernels (on the CPU: their plain versions) against the
JAX package's bench tools: row 26's chained product
(``bench/matmul_shapes.py``) against the JAX kernel body's arithmetic, and
rows 27-30, the GAT megakernel ablation (``bench/ablate_gat_mega.py``),
against the JAX variant factories in interpret mode, every (form, variant) pair, on
identical seeded operands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.bench import ablate_gat_mega as abl
from flowgnn_tpu_torch.bench import matmul_shapes
from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
from flowgnn_tpu_torch.models import base, gat
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import (
    ABL_CAPS as CAPS, ABL_HEADS as HEADS, ABL_L as L, ABL_N as N, ABL_NW as NW, ABL_T as T,
    ABL_W as W, ABL_WINDOW_CAPS, _ablation_operands,
)

S = len(CAPS)
DH = 8
HD = HEADS * DH

# --------------------------------------------------------------------------
# Row 26: the chained matmul.
# --------------------------------------------------------------------------

GRID = 2


def _jax_chain(a, b, layers: int, int8: bool) -> np.ndarray:
    """``matmul_shapes.py:58-74``'s kernel body in jax.numpy over all rows."""
    dt = jnp.int8 if int8 else jnp.bfloat16
    acc = jnp.zeros((a.shape[0], b.shape[1]), jnp.float32)
    a, b = jnp.asarray(a, dt), jnp.asarray(b, dt)
    for _ in range(layers):
        prod = jax.lax.dot_general(
            a, b, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32 if int8 else jnp.float32)
        acc += prod.astype(jnp.float32)
        a = (jnp.maximum(a.astype(jnp.float32), 0)
             + prod[:, :1].astype(jnp.float32) * 1e-9).astype(dt)
    return np.asarray(acc)


def _chain_operands(m, k, n, dtype, ones, seed=0):
    """(torch a, torch b, the same values as numpy f32) for GRID tiles."""
    rng = np.random.default_rng(seed)
    if ones:
        a, b = np.ones((GRID * m, k), np.float32), np.ones((k, n), np.float32)
    elif dtype == "int8":
        a = rng.integers(-127, 128, (GRID * m, k)).astype(np.float32)
        b = rng.integers(-127, 128, (k, n)).astype(np.float32)
    else:
        a, b = rng.normal(0, 1, (GRID * m, k)), rng.normal(0, 1, (k, n))
    dt = matmul_shapes.DTYPES[dtype]
    ta, tb = torch.from_numpy(np.float32(a)).to(dt), torch.from_numpy(np.float32(b)).to(dt)
    return ta, tb, ta.float().numpy(), tb.float().numpy()


@pytest.mark.parametrize("ones", [True, False], ids=["ones", "seeded"])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("n", [128, 136])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_chained_matmul_ref_matches_jax_arithmetic(dtype, m, k, n, layers, ones):
    """On all-ones operands both equal layers·K exactly; on seeded ones int8
    is exact (integer products, the f32 sums in the same layer order) and
    bf16 agrees to 1e-5 of the largest output (f32 sums over K in another
    order; the rare bf16 flip of a relu'd zero row's 1e-9 term moves
    nothing visible)."""
    a, b, a_np, b_np = _chain_operands(m, k, n, dtype, ones)
    got = matmul_shapes.chained_matmul_ref(a, b, layers, GRID)
    want = _jax_chain(a_np, b_np, layers, dtype == "int8")
    assert got.shape == (GRID * m, n) and got.dtype == torch.float32
    if ones:
        assert bool((got == layers * k).all()) and bool((want == layers * k).all())
    elif dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=1e-5)


def test_chained_matmul_cpu_runs_plain_version():
    """A CPU tensor runs the plain version and counts no launch."""
    a, b, _, _ = _chain_operands(8, 64, 128, "bf16", False)
    before = matmul_shapes.chained_matmul.launches
    out = matmul_shapes.chained_matmul(a, b, 2, GRID)
    assert matmul_shapes.chained_matmul.launches == before
    torch.testing.assert_close(out, matmul_shapes.chained_matmul_ref(a, b, 2, GRID), rtol=0, atol=0)


def test_matmul_shapes_measure_cpu():
    """Beside the JAX package's ``test_matmul_shapes_measure_cpu``."""
    assert matmul_shapes.measure(8, 128, 128, 1, 2, "bf16", reps=1, trials=1, device="cpu") > 0


def test_matmul_shapes_main_cpu(monkeypatch, capsys):
    """``main`` prints the launch floor and one row per shape."""
    monkeypatch.setattr(matmul_shapes, "SHAPES", [("tiny", 8, 64, 128, 2, 2, "bf16"),
                                                  ("tiny int8", 8, 64, 136, 2, 2, "int8")])
    matmul_shapes.main(["--device", "cpu", "--reps", "1", "--trials", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# launch floor")
    assert [ln.split()[0] for ln in lines[1:]] == ["tiny", "tiny"]
    assert all("% of nominal bf16 peak" in ln for ln in lines[1:])


# --------------------------------------------------------------------------
# Rows 27-30: the GAT megakernel ablation.
# --------------------------------------------------------------------------

PAIRS = [(form, v) for form, (names, _) in abl.FORMS.items() for v in names]
# The same at W=256, a cluster of two blocks on the card: each form's full
# and nogather (lane i mod W in the second block).
WIDE = 256
WIDE_PAIRS = [(form, v) for form in abl.FORMS for v in ("full", "nogather")]


def _jax_form(form: str, variant: str, ops: dict, dtype=jnp.float32, window: int = W) -> np.ndarray:
    from flowgnn_tpu.bench import ablate_gat_mega as jabl

    caps = ABL_WINDOW_CAPS[window]
    geom = (window, len(caps), HEADS, L, base.POOL_GMAX)
    j = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32 else dtype) for k, v in ops.items()}
    if form == "v1":
        args = [j[k] for k in ("slot_stack", "h0", "prev0", "s0", "skip_w", "proj_w", "a_next",
                               "pool_gl", "pred_hd")]
        return np.asarray(jabl._variant_model(variant, *geom)(*args))
    factory = {"v3": jabl._variant_model_v3, "v4": jabl._variant_model_v4,
               "v5": jabl._variant_model_v5}[form]
    stack = j["onehot_tiles"] if form == "v4" else j["slot_pstack"]
    s0, w = (j["s0x"], j["glue_wx"]) if form == "v5" else (j["s0"], j["glue_w"])
    return np.asarray(factory(variant, *geom, caps)(stack, j["h0"], j["skip0"], s0, w,
                                                    j["pool_gl"], j["pred_hd"]))


def _port_form(form: str, variant: str, ops: dict, dtype=torch.float32,
               window: int = W) -> torch.Tensor:
    t = {k: torch.from_numpy(v.copy()) if v.dtype == np.int32 else torch.from_numpy(v.copy()).to(
        dtype) for k, v in ops.items()}
    caps = ABL_WINDOW_CAPS[window]
    geom = dict(window=window, slots=len(caps), num_heads=HEADS, num_layers=L,
                gmax=base.POOL_GMAX)
    if form == "v1":
        return abl._variant_model(variant, **geom)(
            *(t[k] for k in ("slot_stack", "h0", "prev0", "s0", "skip_w", "proj_w", "a_next",
                             "pool_gl", "pred_hd")))
    factory = {"v3": abl._variant_model_v3, "v4": abl._variant_model_v4,
               "v5": abl._variant_model_v5}[form]
    stack = t["onehot_tiles"] if form == "v4" else t["slot_pstack"]
    s0, w = (t["s0x"], t["glue_wx"]) if form == "v5" else (t["s0"], t["glue_w"])
    return factory(variant, prefix_caps=caps, **geom)(stack, t["h0"], t["skip0"], s0, w,
                                                      t["pool_gl"], t["pred_hd"])


@pytest.fixture(scope="module")
def ablation_ops():
    return _ablation_operands()


@pytest.fixture(scope="module")
def positive_ops():
    return _ablation_operands(positive=True)


@pytest.fixture(scope="module")
def wide_ops():
    return _ablation_operands(window=WIDE)


@pytest.mark.parametrize("form,variant,window", [
    *(pytest.param(f, v, W, id=f"{f}-{v}") for f, v in PAIRS),
    *(pytest.param(f, v, WIDE, id=f"w{WIDE}-{f}-{v}") for f, v in WIDE_PAIRS),
])
def test_ablation_plain_matches_jax(form, variant, window, ablation_ops, positive_ops, wide_ops,
                                    monkeypatch):
    """Each (form, variant)'s plain version against the JAX variant factory in
    interpret mode, f32 at 1e-5 of the largest output (summation order);
    ``noexp`` on nonnegative operands (``_ablation_operands``). At W=256
    each form's full and nogather."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = wide_ops if window == WIDE else positive_ops if variant == "noexp" else ablation_ops
    want = _jax_form(form, variant, ops, window=window)
    before = abl.gat_mega_ablate.launches
    got = _port_form(form, variant, ops, window=window).numpy()
    assert abl.gat_mega_ablate.launches == before
    assert got.shape == want.shape == (NW * base.POOL_GMAX, T)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-2
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", list(abl.FORMS))
def test_ablation_full_bf16_matches_jax(form, ablation_ops, monkeypatch):
    """bf16: both round at the same points; a rounding flip of one
    intermediate moves a pooled sum by a few bf16 ulps of its terms, so
    2e-2 of the largest output."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = {k: v if v.dtype == np.int32 else np.float32(torch.from_numpy(v).to(
        torch.bfloat16).float().numpy()) for k, v in ablation_ops.items()}
    want = _jax_form(form, "full", ops, jnp.bfloat16)
    got = _port_form(form, "full", ops, torch.bfloat16).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-2, atol=2e-2)


def test_ablation_variants_same_as_full(ablation_ops):
    """The TPU layout experiments compute their form's ``full`` function."""
    for form, (_, same) in abl.FORMS.items():
        full = _port_form(form, "full", ablation_ops)
        for v in same:
            torch.testing.assert_close(_port_form(form, v, ablation_ops), full, rtol=0, atol=0)


def _real_batch():
    return abl.molhiv_bucket(24, None, "cpu")


@pytest.mark.parametrize("form", list(abl.FORMS))
def test_ablation_full_matches_row5(form):
    """Each form's ``full`` on a real molhiv bucket equals the port's row-5
    plain version in f32 to 1e-5 (the forms differ from it in f32 only in
    summation order and, v3-v5, the score maps composed with the
    projection)."""
    batch = _real_batch()
    params = loaders.params_from_numpy(loaders.synthetic_gat_params(0), FLOAT32, "cpu")
    c = abl.ablation_operands(params, batch, FLOAT32)
    got = abl.gat_mega_ablate(form, "full", **abl.form_operands(form, c))
    want = local_layer.gat_local_model_slots_ref(**gat.slot_kernel_operands(params, batch, FLOAT32))
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["skip_w", "proj_w", "a_next", "pred_hd", "skip0_w", "glue_w"])
@pytest.mark.parametrize("prec", [FLOAT32, BF16], ids=["f32", "bf16"])
def test_megakernel_operands_match_jax(key, prec):
    from flowgnn_tpu.core import numerics as jnum
    from flowgnn_tpu.models.base import prepare_params
    from flowgnn_tpu.models.gat import megakernel_operands as jax_operands

    np_params = loaders.synthetic_gat_params(3, dim=DH, heads=HEADS, layers=3)
    jprec = jnum.BF16 if prec is BF16 else jnum.FLOAT32
    want = np.asarray(jax_operands(prepare_params(np_params, jprec), jprec)[key], np.float32)
    got = gat.megakernel_operands(loaders.params_from_numpy(np_params, prec, "cpu"), prec)[key]
    assert got.dtype == prec.compute_dtype
    if key == "glue_w" and prec is FLOAT32:
        # Its score columns are proj @ a summed in f32 in another order.
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_expand_score_operands_match_jax(ablation_ops):
    from flowgnn_tpu.bench.ablate_gat_mega import expand_score_operands

    gx, sx = expand_score_operands(jnp.asarray(ablation_ops["glue_w"]),
                                   jnp.asarray(ablation_ops["s0"]), HD, HEADS)
    np.testing.assert_array_equal(ablation_ops["glue_wx"], np.asarray(gx))
    np.testing.assert_array_equal(ablation_ops["s0x"], np.asarray(sx))


def _table(capsys) -> list:
    """The tool's printed table, its ``#`` comment lines left out."""
    return [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("#")]


def test_ablate_main_cpu_prints_table(capsys):
    abl.main(["--device", "cpu", "--graphs", "24", "--reps", "1", "--trials", "1",
              "--variants", "full,v3,v4,v5"])
    lines = _table(capsys)
    assert lines[0].startswith("window=128 slots=")
    assert [ln.split()[0] for ln in lines[1:]] == ["noop", "full", "v3", "v4", "v5"]
    assert all(" dev " in ln for ln in lines[1:])


@pytest.mark.parametrize("window", [256, 384])
def test_ablate_main_cpu_window(window, capsys):
    """``--ell-window`` past 128 (the JAX tool's GAT default is 384) runs the
    plain versions on that window's slot layout."""
    abl.main(["--device", "cpu", "--graphs", "24", "--reps", "1", "--trials", "1",
              "--ell-window", str(window), "--variants", "full"])
    lines = _table(capsys)
    assert lines[0].startswith(f"window={window} slots=")
    assert [ln.split()[0] for ln in lines[1:]] == ["noop", "full"]


def _unpack(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """The product's B [K', n] of each layer from its chunks [L, C, 32·n]
    (the wgmma B operand [4, n, 8] a chunk of 32 input channels)."""
    layers, chunks = tiles.shape[:2]
    return tiles.view(layers, chunks, 4, n, 8).permute(0, 1, 2, 4, 3).reshape(
        layers, chunks * 32, n)


@pytest.mark.parametrize("form", list(abl.FORMS))
def test_ablation_glue_tiles_unpack(form, ablation_ops):
    """The forms' bf16 glue chunks, read back, are the products the kernel
    runs: glue_w's used columns [h ‖ s_tgt ‖ skip ‖ s_src] (v3 / v4),
    glue_wx (v5), [proj_l ‖ skip_{l+1}] with skip at column 64 after
    layer 0's skip_w[0] in the first half of each chunk (v1); zero-padded.
    Packed once per weight set."""
    bf = lambda k: torch.from_numpy(ablation_ops[k]).to(torch.bfloat16)
    w = bf("skip_w" if form == "v1" else "glue_wx" if form == "v5" else "glue_w")
    proj = bf("proj_w")
    tiles = abl.glue_tiles(form, w, proj if form == "v1" else None, HD, HEADS)
    assert tiles is abl.glue_tiles(form, w, proj if form == "v1" else None, HD, HEADS)
    n = abl.GLUE_N[form]
    kp, chunks, elems = local_layer.linear_geometry(HD, n)
    layers = L if form == "v1" else L - 1
    assert tiles.shape == (layers, chunks, elems) and tiles.dtype == torch.bfloat16
    want = torch.zeros(layers, kp, n, dtype=torch.bfloat16)
    rows = lambda x, l: x[l * HD : (l + 1) * HD]
    if form == "v1":
        half = tiles.view(layers, chunks, 2, elems // 2)
        assert not half[0, :, 1].any()
        np.testing.assert_array_equal(_unpack(half[:1, :, 0], n // 2)[0, :HD, :HD].float(),
                                      rows(w, 0).float())
        assert not _unpack(half[:1, :, 0], n // 2)[0, HD:].any()
        for l in range(1, L):
            want[l, :HD, :HD] = rows(proj, l - 1)
            want[l, :HD, local_layer.GAT_PITCH : local_layer.GAT_PITCH + HD] = rows(w, l)
        got = _unpack(tiles[1:], n)
        np.testing.assert_array_equal(got.float(), want[1:].float())
        return
    for l in range(layers):
        if form == "v5":
            want[l, :HD, : 4 * HD] = rows(w, l)
        else:
            pay = w.shape[1] - HD - HEADS
            want[l, :HD, : HD + HEADS] = rows(w, l)[:, : HD + HEADS]
            want[l, :HD, HD + HEADS : 2 * (HD + HEADS)] = rows(w, l)[:, pay:]
    np.testing.assert_array_equal(_unpack(tiles, n).float(), want.float())


def test_ablation_unknown_variant_raises():
    with pytest.raises(ValueError, match="no variant"):
        abl._variant_model_v4("noexp", W, S, HEADS, L, base.POOL_GMAX, CAPS)
