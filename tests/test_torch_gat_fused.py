"""GAT's fused ELL layer (kernel table row 23, ``gat_local_layer_ell``)
against the JAX package: its plain version against the Pallas kernel in
interpret mode (f32 at k=1 and k=2, with and without ``spill_both``; bf16
for its rounding points), the overflow case, and the GAT forward with
``fuse_layers`` on every ELL case of ``test_torch_ell_layer`` against the JAX
forward under ``FUSE_LAYERS``, against the port's plain path and unfused ELL
path, and against the rows the JAX dispatch runs."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgnn_tpu.models.gat as jgat
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import gat
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import (
    ELL_LAYER_GEOMETRY, _gat_layer_operands, _gat_layer_overflow_operands, _port,
)
from test_torch_ell_layer import CASES, G, SMALL, _close, _jax_forward, case_batches
from test_torch_local_layer import _jax_kernel

ROW_CASES = [(g, sp) for g in ("W128", "k2") for sp in (True, False)]
ROW_IDS = [f"{g}-{'spill' if sp else 'nospill'}" for g, sp in ROW_CASES]


def _jax_row(ops: dict, geometry: str, bf16: bool) -> np.ndarray:
    """The Pallas kernel on the port's operands, in its argument forms (lanes
    as u_local / v_local, zeros for a missing ``spill_both``), as float32;
    ``bf16`` casts all but the scores, so the kernel's rounding of s_tgt and
    its exact read of s_src are exercised."""
    ops = dict(ops)
    meta = ops.pop("ell_meta")
    n, hd = ops["h"].shape
    if ops["spill_both"] is None:
        ops["spill_both"] = np.zeros((n, hd + ops["num_heads"]), np.float32)
    ops.update(u_local=meta[:, 0].copy(), v_local=meta[:, 1].copy(),
               k_blocks=ELL_LAYER_GEOMETRY[geometry][2])
    if bf16:
        ops = {k: jnp.asarray(v, jnp.bfloat16)
               if isinstance(v, np.ndarray) and v.dtype == np.float32
               and k not in ("s_src", "s_tgt") else v for k, v in ops.items()}
    return np.asarray(_jax_kernel("gat_local_layer_ell", ops), np.float32)


@pytest.mark.parametrize("geometry,spill", ROW_CASES, ids=ROW_IDS)
def test_gat_layer_ref_matches_jax(geometry, spill, monkeypatch):
    """Row 23's plain version against the Pallas kernel in interpret mode,
    f32 to 1e-5 of the output's scale (summation order only), every part of
    the output (h_next, feat, both scores) live."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gat_layer_operands(geometry, spill)
    got = local_layer.gat_local_layer_ell(**_port(ops, "cpu"))
    want = _jax_row(ops, geometry, bf16=False)
    hd, heads = ops["h"].shape[1], ops["num_heads"]
    assert got.dtype == torch.float32 and got.shape == want.shape == (ops["h"].shape[0],
                                                                      2 * hd + 2 * heads)
    for part in (want[:, :hd], want[:, hd : 2 * hd], want[:, 2 * hd : 2 * hd + heads],
                 want[:, 2 * hd + heads :]):
        assert np.abs(part).max() > 1e-2
    assert (want[:, hd : 2 * hd] < 0).any() and want[:, hd : 2 * hd].min() >= -1  # the ELU's branch
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("geometry,spill", ROW_CASES, ids=ROW_IDS)
def test_gat_layer_ref_matches_jax_bf16(geometry, spill, monkeypatch):
    """bf16 h, ``prev``, ``spill_both`` and weights, f32 scores, in both
    packages: the plain version rounds where the Pallas kernel does (s_tgt
    to bf16, each lane's [score·h_u ‖ score] before the f32 sum, the output
    once; nothing in the epilogue), so nearly every output is bit-equal and
    the rest differ by one bf16 ulp, from the f32 sums' order."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gat_layer_operands(geometry, spill)
    port = dict(_port(ops, "cpu", torch.bfloat16),
                **_port({k: ops[k] for k in ("s_src", "s_tgt")}, "cpu"))
    got = local_layer.gat_local_layer_ell(**port)
    want = _jax_row(ops, geometry, bf16=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    assert (got == want).mean() > 0.99
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def test_gat_layer_overflowing_sentinel_lane_stays_finite():
    """Row 23's plain version skips a sentinel lane (v outside the window)
    whose score overflows exp (100 against float32's 88.7): the output is
    finite and equals the benign run's. (The JAX ``gat_local_layer_ell``
    multiplies exp(raw) by the lane's validity: 0 · inf = NaN there.)"""
    hot, cold = (local_layer.gat_local_layer_ell(**_port(_gat_layer_overflow_operands(h), "cpu"))
                 for h in (True, False))
    assert bool(hot.isfinite().all())
    torch.testing.assert_close(hot, cold, rtol=0, atol=0)


def test_fuse_layers_default_is_read_at_import():
    """``FUSE_LAYERS`` is False unless ``FLOWGNN_GAT_FUSE=1`` is set when the
    module is imported, as in the JAX module."""
    assert gat.FUSE_LAYERS is False and jgat.FUSE_LAYERS is False
    code = ("import os; os.environ['FLOWGNN_GAT_FUSE'] = '1'; "
            "from flowgnn_tpu_torch.models import gat; assert gat.FUSE_LAYERS is True")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("case", list(CASES))
def test_gat_fused_forward_matches_jax_and_plain(case, monkeypatch):
    """GAT with ``fuse_layers`` on the five ELL cases against the JAX forward
    with ``FUSE_LAYERS`` set (f32 1e-5: predictions, every layer's h, the
    pooled h), with the keyword and through the module constant; against the
    port's plain path in f64 (1e-9, where no rounding separates the fused
    epilogue from the glue) and its unfused ELL path in f32 (1e-5)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    monkeypatch.setattr(jgat, "FUSE_LAYERS", True)
    b = case_batches("gat", case)
    params = SMALL["gat"]()
    p32 = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    out, inter = gat.forward(p32, b["ell"], tn.FLOAT32, return_intermediates=True,
                             fuse_layers=True)
    want, layers, h_graph = _jax_forward("gat", params, b["jax"])
    assert out.shape == want.shape and np.ptp(want[:G]) > 1e-4 and np.isfinite(want).all()
    _close(out[:G].numpy(), want[:G], 1e-5)
    assert len(inter["layers"]) == len(layers)
    for got_l, want_l in zip(inter["layers"], layers):
        _close(got_l.numpy(), want_l, 1e-5)
    _close(inter["h_graph"][:G].numpy(), h_graph[:G], 1e-5)
    unfused = gat.forward(p32, b["ell"], tn.FLOAT32)
    _close(out[:G].numpy(), unfused[:G].numpy(), 1e-5)
    monkeypatch.setattr(gat, "FUSE_LAYERS", True)
    np.testing.assert_array_equal(gat.forward(p32, b["ell"], tn.FLOAT32).numpy(), out.numpy())

    p64 = loaders.params_from_numpy(params, tn.FLOAT64, "cpu")
    out, inter = gat.forward(p64, b["ell"], tn.FLOAT64, return_intermediates=True)
    want, want_inter = gat.forward(p64, b["plain"], tn.FLOAT64, return_intermediates=True)
    real = b["ell"]["node_graph"] < G
    np.testing.assert_allclose(out[:G].numpy(), want[:G].numpy(), rtol=1e-9, atol=1e-9)
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        np.testing.assert_allclose(got_l[real].numpy(), want_l[real].numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_gat_fused_dispatch_runs_the_jax_rows(case, fuse, monkeypatch):
    """With ``fuse_layers`` every ELL case calls row 23 for every layer but
    the last and row 17 for the last, and the spill scatter once per layer
    on a blocked tail; without it row 17 every layer and row 23 never; a
    slot and a plain batch ignore the keyword."""
    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    for k in ("gat_local_layer_ell", "gat_local_message_ell", "gat_local_message_slots",
              "gat_local_model_slots"):
        counted(gat, k)
    counted(tb, "windowed_segment_sum")
    b = case_batches("gat", case)
    params = SMALL["gat"]()
    L = params["proj_w"].shape[0]
    p = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    gat.forward(p, b["ell"], tn.FLOAT32, return_intermediates=case == "intermediates",
                fuse_layers=fuse)
    want = ({"gat_local_layer_ell": L - 1, "gat_local_message_ell": 1} if fuse
            else {"gat_local_message_ell": L})
    if case == "spill":
        want["windowed_segment_sum"] = L
    assert calls == want
    calls.clear()
    gat.forward(p, b["plain"], tn.FLOAT32, fuse_layers=fuse)
    assert calls == {}


@pytest.mark.parametrize("case", ["spill", "k2"])
@pytest.mark.parametrize("prec", [tn.FLOAT32, tn.BF16], ids=["f32", "bf16"])
def test_gat_fused_operands_meet_the_kernel_contract(case, prec):
    """What the fused ELL path hands row 23 (and the spill scatter) is what
    the CUDA wrappers accept, on layer 0 and on a later layer, whose h,
    ``prev`` and scores are slices of the previous launch's output: every
    tensor contiguous, int32 lanes, values in the compute dtype."""
    batch, params = case_batches("gat", case)["ell"], SMALL["gat"]()
    p = loaders.params_from_numpy(params, prec, "cpu")
    kernels = gat.layer_kernel_operands(p, batch, prec, fuse_layers=True)
    spill = case == "spill"
    assert set(kernels) == ({"gat_local_layer_ell", "windowed_segment_sum"} if spill
                            else {"gat_local_layer_ell"})
    seen = []
    real = local_layer.gat_local_layer_ell_ref

    def spy(**ops):
        seen.append(ops)
        return real(**ops)

    import unittest.mock as mock
    with mock.patch.object(gat, "gat_local_layer_ell", spy):
        gat.forward(p, batch, prec, fuse_layers=True)
    n, hd, heads = batch["node_feat"].shape[0], 32, 2
    assert len(seen) == params["proj_w"].shape[0] - 1
    for ops in [kernels["gat_local_layer_ell"], *seen]:
        for k, v in ops.items():
            if torch.is_tensor(v):
                assert v.is_contiguous(), k
                assert v.dtype == (torch.int32 if k == "ell_meta" else prec.compute_dtype), k
        assert ops["h"].shape == ops["prev"].shape == (n, hd)
        assert ops["s_src"].shape == ops["s_tgt"].shape == (n, heads)
        assert ops["w_skip"].shape == ops["w_proj"].shape == (hd, hd)
        assert ops["a_mat"].shape == (hd, 2 * heads)
        assert (ops["spill_both"] is not None) == spill
        if spill:
            assert ops["spill_both"].shape == (n, hd + heads)
