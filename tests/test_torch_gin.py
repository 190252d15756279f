"""The port's GIN / GIN-VN forward against the JAX package's, on the plain
edge-list batch (f64) and on the slot batch (f32, the JAX kernel in
interpret mode), plus the port's slot path against its own plain path."""

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

W = 128
CAPS = dict(node_capacity=511, edge_capacity=1024, graph_capacity=16)
G = 8


def _setup(name: str):
    params = synthetic_gin_params(4, dim=32, hidden=64, layers=2)
    jgs = jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G, seed=2))
    tgs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G, seed=2))
    batches = dict(
        jax_plain=jb.as_batch(jg.pack_graphs(jgs, **CAPS)),
        jax_slot=jb.as_batch(jg.pack_graphs_aligned(jgs, window=W, **CAPS),
                             blocked="local_slots", window=W),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **CAPS)), "cpu"),
        slot=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=W, **CAPS),
                                      blocked="local_slots", window=W), "cpu"),
    )
    return tr.get(name).forward, jr.get(name).forward, params, batches


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
def test_gin_forward_matches_jax(name, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    fwd, jfwd, params, b = _setup(name)
    p64 = params_from_numpy(params, tn.FLOAT64, "cpu")
    j64 = jb.prepare_params(params, jn.FLOAT64)
    for fpga_eps in (True, False):
        # Plain edge-list path, f64: the same math in another framework.
        plain = fwd(p64, b["plain"], tn.FLOAT64, fpga_eps=fpga_eps)
        expect = np.asarray(jfwd(j64, b["jax_plain"], jn.FLOAT64, fpga_eps=fpga_eps))
        assert plain.dtype == torch.float64 and plain.shape == expect.shape
        np.testing.assert_allclose(plain[:G].numpy(), expect[:G], rtol=1e-9, atol=1e-9)
        # The port's slot path (plain version of the kernel) equals its own
        # plain path: a different layout, the same sums.
        slot = fwd(p64, b["slot"], tn.FLOAT64, fpga_eps=fpga_eps)
        np.testing.assert_allclose(slot[:G].numpy(), plain[:G].numpy(),
                                   rtol=1e-9, atol=1e-9)

    # Slot path in f32 against the JAX kernel; ε is not the identity for
    # GIN-VN, so the (1+ε)·h term is checked too.
    fpga_eps = name == "gin"
    p32 = params_from_numpy(params, tn.FLOAT32, "cpu")
    j32 = jb.prepare_params(params, jn.FLOAT32)
    got = fwd(p32, b["slot"], tn.FLOAT32, fpga_eps=fpga_eps)
    expect = np.asarray(jfwd(j32, b["jax_slot"], jn.FLOAT32, fpga_eps=fpga_eps))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)


def test_slot_meta_is_live():
    """Dead-wiring guard: corrupting the slot metadata changes the output."""
    fwd, _, params, b = _setup("gin")
    p = params_from_numpy(params, tn.FLOAT32, "cpu")
    good = fwd(p, b["slot"], tn.FLOAT32)
    corrupt = dict(b["slot"])
    meta = corrupt["slot_meta"].clone()
    meta[:, 0] = torch.where(meta[:, 0] < W // 2, 0, meta[:, 0])  # every source → row W/2
    corrupt["slot_meta"] = meta
    bad = fwd(p, corrupt, tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-5, atol=1e-5)


def test_unported_cases_raise():
    """A slot batch the megakernel does not take (no ``pool_gl``,
    ``return_intermediates``) runs the plain loop on its own edge list, as
    the JAX package's dispatch does, and gives the kernel's predictions;
    the legacy local and edge-block layouts, which raised before they were
    ported, run (rows 10 and 24) and give them too; the fixed-point mode,
    which raised before it was ported, runs the plain loop on the slot
    batch, with or without ``pool_gl``, its predictions on the grid."""
    fwd, _, params, b = _setup("gin")
    p = params_from_numpy(params, tn.FLOAT32, "cpu")
    kernel = fwd(p, b["slot"], tn.FLOAT32)
    no_pool = {k: v for k, v in b["slot"].items() if k != "pool_gl"}
    out, inter = fwd(p, b["slot"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == params["mlp1_w"].shape[0] + 1
    for got in (out, fwd(p, no_pool, tn.FLOAT32)):
        np.testing.assert_allclose(got[:G].numpy(), kernel[:G].numpy(), rtol=1e-5, atol=1e-5)
    packed = tg.pack_graphs_aligned(
        tr.apply_transforms(tr.get("gin"), ts.synthetic_molhiv(G, seed=2)), window=W, **CAPS)
    for layout, key in (("local", "loc_window"), (True, "blk_window")):
        batch = tb.to_device(tb.as_batch(packed, blocked=layout), "cpu")
        assert key in batch
        for kw in ({}, dict(fused=True)):
            np.testing.assert_allclose(fwd(p, batch, tn.FLOAT32, **kw)[:G].numpy(),
                                       kernel[:G].numpy(), rtol=1e-5, atol=1e-5)
    pf = params_from_numpy(params, tn.FIXED_16_6, "cpu")
    fixed = fwd(pf, b["slot"], tn.FIXED_16_6)
    assert torch.equal(fixed, fwd(pf, no_pool, tn.FIXED_16_6))
    scaled = fixed[:G].double() * tn.AP_FIXED_16_6.scale
    assert torch.equal(scaled, scaled.round()) and not torch.equal(fixed, kernel)
