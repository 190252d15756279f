"""Kernel table rows 16, 17, 18 and 20 and the ELL paths of DGN and GAT,
against the JAX package: each row's plain version against its Pallas kernel
in interpret mode (f32 at W=128 and, for the ELL rows, at k=2; bf16 with the
node terms and scores left in f32, so that each rounding point the plain
version repeats is exercised), and the DGN and GAT forward on every ELL
case of ``test_torch_ell_layer`` (a spill tail, two edge blocks per window,
no pooling layout, intermediates, a pad-only tail) against the JAX forward,
against the port's plain path and against the rows the JAX dispatch runs.
A masked lane whose score overflows exp adds nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import gat
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import (
    ELL_LAYER_GEOMETRY, _dgn_gat_ell_operands, _ell_layer_batch, _gat_ell_batch_operands,
    _gat_ell_overflow_operands, _pna_layer_operands, _port,
)
from test_torch_ell_layer import CASES, G, SMALL, _close, case_batches, check_forward_matches_jax
from test_torch_local_layer import _jax_kernel

ELL_ROWS = ("dgn_local_message_ell", "dgn_local_layer_ell", "gat_local_message_ell")
ROW_CASES = [("pna_local_layer", "W128")] + [
    (k, g) for k in ELL_ROWS for g in ("W128", "k2")]
ROW_IDS = [f"{k}-{g}" for k, g in ROW_CASES]
# Operands that stay float32 in the bf16 cases: the node terms and scores
# the TPU kernels round to h's dtype (or, s_src, read exactly), so the plain
# versions' rounding of them is exercised.
KEEP_F32 = ("eig", "inv_deg", "eigw_sum", "inv_abssum", "t", "scale", "s_src", "s_tgt")


def _operands(kernel: str, geometry: str) -> dict:
    return (_pna_layer_operands() if kernel == "pna_local_layer"
            else _dgn_gat_ell_operands(kernel, geometry))


def _jax_row(kernel: str, ops: dict, geometry: str, bf16: bool) -> np.ndarray:
    """The Pallas kernel on the port's operands, in its argument forms (lanes
    as u_local / v_local; row 16's (m1, m2) concatenated), as float32."""
    ops = dict(ops)
    if kernel != "pna_local_layer":
        meta = ops.pop("ell_meta")
        ops.update(u_local=meta[:, 0].copy(), v_local=meta[:, 1].copy(),
                   k_blocks=ELL_LAYER_GEOMETRY[geometry][2])
    if bf16:
        ops = {k: jnp.asarray(v, jnp.bfloat16)
               if isinstance(v, np.ndarray) and v.dtype == np.float32 and k not in KEEP_F32
               else v for k, v in ops.items()}
    out = _jax_kernel(kernel, ops)
    if kernel == "dgn_local_message_ell":
        out = np.concatenate(list(out), axis=1)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("kernel,geometry", ROW_CASES, ids=ROW_IDS)
def test_new_rows_ref_match_jax(kernel, geometry, monkeypatch):
    """The plain versions of rows 20, 16, 18 and 17 against the Pallas
    kernels in interpret mode, f32 to 1e-5 of the output's scale (summation
    order only)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _operands(kernel, geometry)
    got = getattr(local_layer, kernel)(**_port(ops, "cpu"))
    expect = _jax_row(kernel, ops, geometry, bf16=False)
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2
    _close(got.numpy(), expect, 1e-5)


@pytest.mark.parametrize("kernel,geometry", ROW_CASES, ids=ROW_IDS)
def test_new_rows_ref_match_jax_bf16(kernel, geometry, monkeypatch):
    """bf16 h and weights, f32 node terms and scores, in both packages: the
    plain versions round where the Pallas kernels do (node terms, s_tgt,
    each lane's products, the stats or channels before the product, the
    output), so nearly every output is bit-equal and the rest differ by one
    bf16 ulp, from the f32 sums' order."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _operands(kernel, geometry)
    port = dict(_port(ops, "cpu", torch.bfloat16),
                **_port({k: v for k, v in ops.items() if k in KEEP_F32}, "cpu"))
    got = getattr(local_layer, kernel)(**port)
    expect = _jax_row(kernel, ops, geometry, bf16=True)
    assert got.dtype == torch.bfloat16 and got.shape == expect.shape
    got = got.float().numpy()
    assert (got == expect).mean() > 0.99
    np.testing.assert_allclose(got, expect, rtol=2 ** -7, atol=2 ** -7 * np.abs(expect).max())


@pytest.mark.parametrize("geometry", ["W128", "k2"])
@pytest.mark.parametrize("heads", [1, 32])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gat_ell_ref_matches_jax_at_row17_edges(geometry, heads, bf16, monkeypatch):
    """Row 17's plain version at the edges of what its kernel takes, H·D =
    128 with 1 head (D = 128) and 32 heads (D = 4), against the Pallas
    kernel in interpret mode: f32 to 1e-5 of the output's scale; bf16 h with
    f32 scores, > 99% bit-equal, the rest one bf16 ulp apart."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    kernel = "gat_local_message_ell"
    ops = _gat_ell_batch_operands(_ell_layer_batch(geometry, 19), np.random.default_rng(19),
                                  128, heads)
    if bf16:
        port = dict(_port(ops, "cpu", torch.bfloat16),
                    **_port({k: v for k, v in ops.items() if k in KEEP_F32}, "cpu"))
    else:
        port = _port(ops, "cpu")
    got = getattr(local_layer, kernel)(**port)
    expect = _jax_row(kernel, ops, geometry, bf16=bf16)
    assert got.shape == expect.shape == (ops["h"].shape[0], 128 + heads)
    assert np.abs(expect).max() > 1e-2
    if not bf16:
        _close(got.numpy(), expect, 1e-5)
        return
    got = got.float().numpy()
    assert (got == expect).mean() > 0.99
    np.testing.assert_allclose(got, expect, rtol=2 ** -7, atol=2 ** -7 * np.abs(expect).max())


def test_gat_ell_overflowing_sentinel_lane_stays_finite():
    """Row 17's plain version skips a sentinel lane (v outside the window)
    whose score overflows exp (100 against float32's 88.7): the output is
    finite and equals the benign run's. (The JAX ``gat_local_message_ell``
    multiplies exp(raw) by the lane's validity: 0 · inf = NaN there.)"""
    hot, cold = (local_layer.gat_local_message_ell(**_port(_gat_ell_overflow_operands(h), "cpu"))
                 for h in (True, False))
    assert bool(hot.isfinite().all())
    torch.testing.assert_close(hot, cold, rtol=0, atol=0)


def test_gat_spill_pad_lane_overflow_stays_finite():
    """A pad lane of the spill tail (both ends the pad node) whose raw score
    overflows exp is masked before the exp: it adds exactly 0, where the JAX
    package's exp(raw) · mask is NaN."""
    n, heads = 6, 2
    h = torch.randn(n, heads, 4, generator=torch.Generator().manual_seed(0))
    s = torch.zeros(n, heads)
    s[n - 1] = 100.0  # the pad node
    lanes = torch.tensor([1, n - 1, n - 1]), torch.tensor([2, n - 1, n - 1])
    real = torch.tensor([True, False, False])
    vals = gat.spill_values(h, s, s.clone(), lanes, real)
    assert bool(vals.isfinite().all()) and not vals[1:].any()
    assert torch.isinf(gat._leaky_exp(s[n - 1] + s[n - 1])).all()


@pytest.mark.parametrize("name", ["dgn", "gat"])
@pytest.mark.parametrize("case", list(CASES))
def test_dgn_gat_ell_forward_matches_jax_and_plain(name, case, monkeypatch):
    """The per-layer ELL path of DGN and GAT against the JAX forward (f32,
    1e-5: outputs and every intermediate) and against the port's plain
    edge-list path in f64 (predictions, pooled h and every layer's rows of
    real nodes; GAT 1e-9, DGN 1e-6: its |m2 − eigw_sum·h| / abssum
    amplifies the factoring's summation-order noise)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = case_batches(name, case)
    check_forward_matches_jax(name, case, b)

    tol = 1e-6 if name == "dgn" else 1e-9
    p64 = loaders.params_from_numpy(SMALL[name](), tn.FLOAT64, "cpu")
    fwd = tr.get(name).forward
    out, inter = fwd(p64, b["ell"], tn.FLOAT64, return_intermediates=True)
    want, want_inter = fwd(p64, b["plain"], tn.FLOAT64, return_intermediates=True)
    assert out.dtype == torch.float64
    real = b["ell"]["node_graph"] < G
    np.testing.assert_allclose(out[:G].numpy(), want[:G].numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(inter["h_graph"][:G].numpy(), want_inter["h_graph"][:G].numpy(),
                               rtol=tol, atol=tol)
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        np.testing.assert_allclose(got_l[real].numpy(), want_l[real].numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["dgn", "gat"])
@pytest.mark.parametrize("case", list(CASES))
def test_dgn_gat_ell_dispatch_runs_the_jax_rows(name, case, monkeypatch):
    """Each ELL forward case calls the kernels the JAX dispatch runs, once
    per layer: DGN row 18 with no spill tail, and with one row 16 and the
    spill scatter (row 24; a tail of pad lanes only sums by receiver); GAT
    row 17, with the spill scatter on a blocked tail; no slot kernel."""
    from flowgnn_tpu_torch.models import base as tbase
    from flowgnn_tpu_torch.models import dgn

    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    for mod, fn_name in ((dgn, "dgn_local_layer_ell"), (dgn, "dgn_local_message_ell"),
                         (dgn, "dgn_local_layer_slots"), (dgn, "dgn_local_model"),
                         (gat, "gat_local_message_ell"), (gat, "gat_local_message_slots"),
                         (gat, "gat_local_model_slots"), (tbase, "windowed_segment_sum")):
        counted(mod, fn_name)
    b = case_batches(name, case)
    params = SMALL[name]()
    tr.get(name).forward(loaders.params_from_numpy(params, tn.FLOAT32, "cpu"), b["ell"],
                         tn.FLOAT32, return_intermediates=case == "intermediates")
    L = (params["posttrans_w"] if name == "dgn" else params["proj_w"]).shape[0]
    tail = case in ("spill", "pad_tail")
    if name == "dgn":
        want = {"dgn_local_message_ell": L} if tail else {"dgn_local_layer_ell": L}
    else:
        want = {"gat_local_message_ell": L}
    if case == "spill":
        want["windowed_segment_sum"] = L
    assert calls == want


@pytest.mark.parametrize("name", ["dgn", "gat"])
def test_dgn_gat_ell_spill_tail_is_live(name):
    """Dead-wiring guard: routing the ELL spill tail's lanes to the pad node
    changes DGN's and GAT's output."""
    b = case_batches(name, "spill")
    p = loaders.params_from_numpy(SMALL[name](), tn.FLOAT32, "cpu")
    good = tr.get(name).forward(p, b["ell"], tn.FLOAT32)
    pl = b["ell"]["loc_ulocal"].shape[0]
    recv = b["ell"]["receivers"].clone()
    recv[pl:] = b["ell"]["node_feat"].shape[0] - 1
    vloc = torch.full_like(b["ell"]["spill_blk_vlocal"], 512)
    bad = tr.get(name).forward(p, dict(b["ell"], receivers=recv, spill_blk_vlocal=vloc), tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,case", [("dgn", "spill"), ("dgn", "k2"), ("gat", "spill"),
                                       ("gat", "k2"), ("pna", None)])
@pytest.mark.parametrize("prec", [tn.FLOAT32, tn.BF16], ids=["f32", "bf16"])
def test_new_rows_operands_meet_the_kernel_contract(name, case, prec):
    """What the DGN and GAT per-layer ELL paths (rows 16 or 18, 17, and the
    spill scatter) and PNA's no-spill per-layer slot path (row 20) hand
    their kernels is what the CUDA wrappers accept: every tensor contiguous,
    int32 lanes, values in the compute dtype, the shapes they check."""
    from flowgnn_tpu_torch.models import dgn, pna
    from test_torch_cuda import _slot_batch

    model = {"dgn": dgn, "gat": gat, "pna": pna}[name]
    if name == "pna":
        batch = tb.to_device(_slot_batch("pna", 11), "cpu")
        params = loaders.synthetic_pna_params(0, dim=16, layers=2)
    else:
        batch, params = case_batches(name, case)["ell"], SMALL[name]()
    kernels = model.layer_kernel_operands(loaders.params_from_numpy(params, prec, "cpu"), batch,
                                          prec)
    spill = case == "spill"
    want = {"dgn": "dgn_local_message_ell" if spill else "dgn_local_layer_ell",
            "gat": "gat_local_message_ell", "pna": "pna_local_layer"}[name]
    assert set(kernels) == ({want, "windowed_segment_sum"} if spill else {want})
    n = batch["node_feat"].shape[0]
    for kname, ops in kernels.items():
        for k, v in ops.items():
            if not torch.is_tensor(v):
                continue
            assert v.is_contiguous(), (kname, k)
            if k in ("ell_meta", "slot_src", "v_local", "block_window"):
                assert v.dtype == torch.int32, (kname, k)
            else:
                assert v.dtype == prec.compute_dtype, (kname, k)
    ops = kernels[want]
    d = ops["h"].shape[1]
    if name == "pna":
        assert ops["w_cat"].shape == (4 * d, 3 * d) and ops["b"].shape == (1, d)
    else:
        assert ops["ell_meta"].shape == (batch["loc_ulocal"].shape[0], 5) and ops["h"].shape[0] == n
    if want == "dgn_local_layer_ell":
        assert ops["w_post"].shape == (2 * d, d) and ops["inv_abssum"].shape == (n,)
    if name == "gat":
        assert ops["s_src"].shape == (n, ops["num_heads"]) and d % ops["num_heads"] == 0


@pytest.mark.parametrize("kernel,name,profile,window", [
    ("gat_local_message_ell", "gat", "molhiv", None),
    ("gat_local_message_ell", "gat", "hep10k", 128),
    ("dgn_local_layer_ell", "dgn", "molhiv", None),
    ("dgn_local_message_ell", "dgn", "hep10k", 128)])
def test_layer_kernels_tool_launches_what_the_paths_launch(kernel, name, profile, window):
    """``bench.layer_kernels`` times rows 17, 18 and 16 on the launches their
    paths make: each bucket's layer-0 operands once per layer (row 17 on
    GAT's unfused ELL path, every layer, with a spill tail on hep10k at
    W=128; row 18 on DGN's molhiv ELL stream, no tail, with bf16 posttrans
    chunks; row 16 on DGN's hep10k W=128 stream, with a tail); every
    launch's operands are ones the kernel's plain version takes."""
    from flowgnn_tpu_torch.bench import layer_kernels

    batches = layer_kernels.stream(name, profile, 60, "local_ell", window, "cpu")
    prec = tn.BF16 if kernel == "dgn_local_layer_ell" else tn.FLOAT32
    ops = layer_kernels.calls(kernel, name, batches, prec, "cpu")
    assert len(ops) == tr.get(name).num_layers * len(batches)
    assert all((tb.ell_spill(b) is not None) == (window == 128) for b in batches)
    if kernel == "dgn_local_layer_ell":
        assert all(o["posttrans_tiles"] is not None for o in ops)
    out = getattr(local_layer, f"{kernel}_ref")(**ops[-1])
    assert bool(out.float().isfinite().all())
