"""The port's GCN forward against the JAX package's, on the plain edge-list
batch (f64) and on the slot batch (f32, the JAX kernel in interpret mode),
the port's slot path against its own plain path, and the weight loader
against the JAX loader."""

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.params import loaders as jl
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders as tl

W = 128
CAPS = dict(node_capacity=511, edge_capacity=1024, graph_capacity=16)
G = 8


@pytest.fixture(scope="module")
def setup():
    params = tl.synthetic_gcn_params(4, dim=32, layers=2)
    jgs = jr.apply_transforms(jr.get("gcn"), js.synthetic_molhiv(G, seed=2))
    tgs = tr.apply_transforms(tr.get("gcn"), ts.synthetic_molhiv(G, seed=2))
    batches = dict(
        jax_plain=jb.as_batch(jg.pack_graphs(jgs, **CAPS)),
        jax_slot=jb.as_batch(jg.pack_graphs_aligned(jgs, window=W, **CAPS),
                             blocked="local_slots", window=W),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **CAPS)), "cpu"),
        slot=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=W, **CAPS),
                                      blocked="local_slots", window=W), "cpu"),
    )
    return tr.get("gcn").forward, jr.get("gcn").forward, params, batches


def test_gcn_plain_and_slot_f64(setup):
    fwd, jfwd, params, b = setup
    p64 = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    # Plain edge-list path, f64: the same math in another framework.
    plain = fwd(p64, b["plain"], tn.FLOAT64)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT64), b["jax_plain"], jn.FLOAT64))
    assert plain.dtype == torch.float64 and plain.shape == expect.shape
    assert np.abs(expect[:G]).max() > 1e-2
    np.testing.assert_allclose(plain[:G].numpy(), expect[:G], rtol=1e-9, atol=1e-9)
    # The port's slot path (plain version of the kernel) equals its own
    # plain path: another layout and the folded BatchNorm, the same sums.
    slot = fwd(p64, b["slot"], tn.FLOAT64)
    np.testing.assert_allclose(slot[:G].numpy(), plain[:G].numpy(), rtol=1e-9, atol=1e-9)


def test_gcn_slot_f32_matches_jax_kernel(setup, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    fwd, jfwd, params, b = setup
    got = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), b["slot"], tn.FLOAT32)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), b["jax_slot"], jn.FLOAT32))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)


def test_gcn_slot_meta_is_live(setup):
    """Dead-wiring guard: corrupting the slot metadata changes the output."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    good = fwd(p, b["slot"], tn.FLOAT32)
    corrupt = dict(b["slot"])
    meta = corrupt["slot_meta"].clone()
    meta[:, 0] = torch.where(meta[:, 0] < W // 2, 0, meta[:, 0])  # every source → row W/2
    corrupt["slot_meta"] = meta
    bad = fwd(p, corrupt, tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-5, atol=1e-5)


def test_gcn_dispatch(setup):
    """A slot batch the kernel does not take runs the plain loop on its own
    edge list, as the JAX package's dispatch does; unported layouts raise."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    kernel = fwd(p, b["slot"], tn.FLOAT64)
    out, inter = fwd(p, b["slot"], tn.FLOAT64, return_intermediates=True)
    assert len(inter["layers"]) == 3
    no_pool = {k: v for k, v in b["slot"].items() if k != "pool_gl"}
    for got in (out, fwd(p, no_pool, tn.FLOAT64)):
        np.testing.assert_allclose(got[:G].numpy(), kernel[:G].numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fwd(p, dict(b["plain"], loc_ulocal=b["plain"]["senders"]), tn.FLOAT64)


def test_load_gcn_matches_jax(tmp_path):
    """The fseek offset map, on a file of np.arange floats; the synthetic
    set has the loader's keys and shapes."""
    np.arange(76906, dtype="<f4").tofile(tmp_path / "gcn_ep1_dim100.weights.all.bin")
    got, expect = tl.load_gcn(str(tmp_path)), jl.load_gcn(str(tmp_path))
    assert list(got) == list(expect)
    for k in expect:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], expect[k]), k
    synth = tl.synthetic_gcn_params(0)
    assert {k: v.shape for k, v in synth.items()} == {k: v.shape for k, v in expect.items()}
    assert (synth["bn_var"] > 0).all()
