"""The port's DGN forward against the JAX package's, on the plain edge-list
batch (f64) and on the slot batch (f32, the JAX kernel in interpret mode),
the port's slot path against its own plain path, and the weight loader
against the JAX loader. The graph set holds a one-node graph, whose node has
no edge: its eigenvector sum is 0 and its out-degree 0, so it takes the
EIG_EPS guard and the degree clamp."""

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.params import loaders as jl
from flowgnn_tpu_torch.core.features import ATOM_FEATURE_DIMS
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import dgn
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders as tl

W = 128
CAPS = dict(node_capacity=511, edge_capacity=1024, graph_capacity=16, with_eigen=True)
G = 8
LONE = G - 1  # index of the one-node graph


def _graphs(syn):
    return syn.synthetic_molhiv(G - 1, seed=2) + [
        syn.random_molecule_graph(np.random.default_rng(9), num_nodes=1)
    ]


@pytest.fixture(scope="module")
def setup():
    params = tl.synthetic_dgn_params(4, dim=32, layers=2)
    jgs = jr.apply_transforms(jr.get("dgn"), _graphs(js))
    tgs = tr.apply_transforms(tr.get("dgn"), _graphs(ts))
    assert tgs[LONE].num_nodes == 1 and tgs[LONE].num_edges == 0
    batches = dict(
        jax_plain=jb.as_batch(jg.pack_graphs(jgs, **CAPS)),
        jax_slot=jb.as_batch(jg.pack_graphs_aligned(jgs, window=W, **CAPS),
                             blocked="local_slots", window=W),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **CAPS)), "cpu"),
        slot=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=W, **CAPS),
                                      blocked="local_slots", window=W), "cpu"),
    )
    return tr.get("dgn").forward, jr.get("dgn").forward, params, batches


def test_dgn_plain_and_slot_f64(setup):
    fwd, jfwd, params, b = setup
    p64 = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    # Plain edge-list path, f64: the same math in another framework. DGN's
    # |m2 − eigw_sum·h| / abssum amplifies summation-order noise by
    # near-cancellation, so 1e-6 (the JAX package's own DGN tolerance).
    plain = fwd(p64, b["plain"], tn.FLOAT64)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT64), b["jax_plain"], jn.FLOAT64))
    assert plain.dtype == torch.float64 and plain.shape == expect.shape
    assert np.abs(expect[:G]).max() > 1e-2
    np.testing.assert_allclose(plain[:G].numpy(), expect[:G], rtol=1e-6, atol=1e-6)
    # The port's slot path (plain version of the kernel, m2 factored as
    # Σ e_u·h_u − e_v·m1) equals its own plain path.
    slot = fwd(p64, b["slot"], tn.FLOAT64)
    np.testing.assert_allclose(slot[:G].numpy(), plain[:G].numpy(), rtol=1e-6, atol=1e-6)


def test_dgn_slot_f32_matches_jax_kernel(setup, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    fwd, jfwd, params, b = setup
    got = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), b["slot"], tn.FLOAT32)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), b["jax_slot"], jn.FLOAT32))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)


def test_dgn_one_node_graph_is_guarded(setup):
    """The one-node graph's node has no in-edge and no out-edge: its
    eigenvector sum takes EIG_EPS and its out-degree the clamp to 1, so
    both paths give it a finite prediction, the same one."""
    fwd, _, params, b = setup
    lone = b["plain"]["node_graph"] == LONE
    _, _, _, abssum, deg = dgn._node_terms(b["plain"], tn.FLOAT64)
    assert (abssum[lone] == dgn.EIG_EPS).all() and (deg[lone] == 1).all()
    p = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    outs = [fwd(p, b[k], tn.FLOAT64)[LONE] for k in ("plain", "slot")]
    assert all(bool(o.isfinite().all()) for o in outs)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-9, atol=1e-9)


def test_dgn_slot_src_is_live(setup):
    """Dead-wiring guard: corrupting the slot sources changes the output."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    good = fwd(p, b["slot"], tn.FLOAT32)
    corrupt = dict(b["slot"])
    src = corrupt["slot_src"].clone()
    src[src < W] = 0  # every source → the window's first row
    corrupt["slot_src"] = src
    bad = fwd(p, corrupt, tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-5, atol=1e-5)


def test_dgn_unported_cases_raise(setup):
    """A slot batch the megakernel does not take (``return_intermediates``,
    no ``pool_gl``) runs the per-layer slot path, ``dgn_local_layer_slots``
    (kernel table row 22), as the JAX package does, and gives the
    megakernel's predictions; so does an ELL batch, which raised before the
    per-layer ELL kernels were ported and now runs ``dgn_local_layer_ell``
    (row 18); the legacy dynamic-window and edge-block layouts, which raised
    before they were ported, run the plain loop (the latter through the
    windowed scatter, row 24); the fixed-point mode, which raised before it
    was ported, runs the plain loop on the slot batch, with or without
    ``pool_gl``, its predictions on ap_fixed<16,3>'s grid."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    whole = fwd(p, b["slot"], tn.FLOAT32)
    per_layer, inter = fwd(p, b["slot"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3
    no_pool = {k: v for k, v in b["slot"].items() if k != "pool_gl"}
    ell = tb.to_device(tb.as_batch(tg.pack_graphs_aligned(
        tr.apply_transforms(tr.get("dgn"), _graphs(ts)), window=W, **CAPS),
        blocked="local_ell", window=W, block=512), "cpu")
    for got in (per_layer, fwd(p, no_pool, tn.FLOAT32), fwd(p, ell, tn.FLOAT32)):
        np.testing.assert_allclose(got[:G].numpy(), whole[:G].numpy(), rtol=1e-5, atol=1e-5)
    packed = tg.pack_graphs_aligned(tr.apply_transforms(tr.get("dgn"), _graphs(ts)), window=W,
                                    **CAPS)
    for layout, key in (("local", "loc_window"), (True, "blk_window")):
        batch = tb.to_device(tb.as_batch(packed, blocked=layout), "cpu")
        assert key in batch
        np.testing.assert_allclose(fwd(p, batch, tn.FLOAT32)[:G].numpy(), whole[:G].numpy(),
                                   rtol=1e-5, atol=1e-5)
    pf = tl.params_from_numpy(params, tn.FIXED_16_3, "cpu")
    fixed = fwd(pf, b["slot"], tn.FIXED_16_3)
    assert torch.equal(fixed, fwd(pf, no_pool, tn.FIXED_16_3))
    scaled = fixed[:G].double() * tn.AP_FIXED_16_3.scale
    assert torch.equal(scaled, scaled.round()) and not torch.equal(fixed, whole)
    out, inter = fwd(p, b["plain"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3 and out.shape == (CAPS["graph_capacity"] + 1, 1)


def test_load_dgn_matches_jax(tmp_path):
    """The fseek offset map, on a file of np.arange floats; the synthetic
    set has the loader's keys and shapes, and zero atom-table rows past each
    feature's vocabulary, as the loader pads them."""
    np.arange(104051, dtype="<f4").tofile(tmp_path / "dgn_ep1_noBN_dim100.weights.all.bin")
    got, expect = tl.load_dgn(str(tmp_path)), jl.load_dgn(str(tmp_path))
    assert list(got) == list(expect)
    for k in expect:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], expect[k]), k
    synth = tl.synthetic_dgn_params(0)
    assert {k: v.shape for k, v in synth.items()} == {k: v.shape for k, v in expect.items()}
    for i, vocab in enumerate(ATOM_FEATURE_DIMS):
        table = synth["atom_tables"][i]
        assert table[:vocab].all() and not table[vocab:].any(), i
