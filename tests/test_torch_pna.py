"""The port's PNA forward against the JAX package's, on the plain edge-list
batch (f64) and on the slot batch (f32, the JAX kernel in interpret mode),
the port's slot path against its own plain path, the running min / max
against the JAX segment ops, and the weight loader against the JAX loader.
The graph set holds a one-node graph, whose node has no in-edge, so the
ap_fixed seeds of the running min / max reach the output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.ops import segment as jseg
from flowgnn_tpu.params import loaders as jl
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import pna
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import segment as tseg
from flowgnn_tpu_torch.params import loaders as tl

W = 128
CAPS = dict(node_capacity=511, edge_capacity=1024, graph_capacity=16)
G = 8
LONE = G - 1  # index of the one-node graph


def _graphs(syn):
    return syn.synthetic_molhiv(G - 1, seed=2) + [
        syn.random_molecule_graph(np.random.default_rng(9), num_nodes=1)
    ]


@pytest.fixture(scope="module")
def setup():
    params = tl.synthetic_pna_params(4, dim=32, layers=2)
    jgs = jr.apply_transforms(jr.get("pna"), _graphs(js))
    tgs = tr.apply_transforms(tr.get("pna"), _graphs(ts))
    assert tgs[LONE].num_nodes == 1 and tgs[LONE].num_edges == 0
    batches = dict(
        jax_plain=jb.as_batch(jg.pack_graphs(jgs, **CAPS)),
        jax_slot=jb.as_batch(jg.pack_graphs_aligned(jgs, window=W, **CAPS),
                             blocked="local_slots", window=W),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **CAPS)), "cpu"),
        slot=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=W, **CAPS),
                                      blocked="local_slots", window=W), "cpu"),
    )
    return tr.get("pna").forward, jr.get("pna").forward, params, batches


def test_pna_plain_and_slot_f64(setup):
    fwd, jfwd, params, b = setup
    p64 = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    # Plain edge-list path, f64: the same math in another framework.
    plain = fwd(p64, b["plain"], tn.FLOAT64)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT64), b["jax_plain"], jn.FLOAT64))
    assert plain.dtype == torch.float64 and plain.shape == expect.shape
    assert np.abs(expect[:G]).max() > 1e-2
    np.testing.assert_allclose(plain[:G].numpy(), expect[:G], rtol=1e-9, atol=1e-9)
    # The port's slot path (plain version of the kernel) equals its own
    # plain path: another layout, the same aggregates.
    slot = fwd(p64, b["slot"], tn.FLOAT64)
    np.testing.assert_allclose(slot[:G].numpy(), plain[:G].numpy(), rtol=1e-9, atol=1e-9)


def test_pna_slot_f32_matches_jax_kernel(setup, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    fwd, jfwd, params, b = setup
    got = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), b["slot"], tn.FLOAT32)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), b["jax_slot"], jn.FLOAT32))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)


def test_pna_seeds_reach_the_output(setup, monkeypatch):
    """The one-node graph's node has no in-edge: its min / max are the
    seeds, so moving the seeds moves its prediction and no other."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    base_out = {k: fwd(p, b[k], tn.FLOAT64) for k in ("plain", "slot")}
    monkeypatch.setattr(pna, "MIN_INIT", -16.0)
    monkeypatch.setattr(pna, "MAX_INIT", 16.0)
    for k, want in base_out.items():
        moved = fwd(p, b[k], tn.FLOAT64)
        assert abs(moved[LONE] - want[LONE]).item() > 1e-6, k
        np.testing.assert_array_equal(moved[:LONE].numpy(), want[:LONE].numpy())


def test_pna_slot_src_is_live(setup):
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


def test_pna_unported_cases_raise(setup):
    """A slot batch with no spill tail that the megakernel does not take
    (intermediates asked for, no ``pool_gl``) raised before
    ``pna_local_layer`` (kernel table row 20) was ported; it now runs one
    row-20 launch per layer and gives the megakernel's predictions. An ELL
    batch runs the plain loop: PNA has no ELL kernel in either package
    (tests/test_torch_ell_layer.py holds it against JAX). A slot batch with a
    spill tail runs the per-layer slot path (row 19; tests/test_torch_spill.py
    holds it against the JAX package). The legacy dynamic-window and
    edge-block layouts, which raised before they were ported, run the plain
    loop (the latter through the windowed scatter, row 24)."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    whole = fwd(p, b["slot"], tn.FLOAT32)
    no_pool = {k: v for k, v in b["slot"].items() if k != "pool_gl"}
    per_layer, inter = fwd(p, b["slot"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3
    for got in (per_layer, fwd(p, no_pool, tn.FLOAT32)):
        np.testing.assert_allclose(got[:G].numpy(), whole[:G].numpy(), rtol=1e-5, atol=1e-5)
    packed = tg.pack_graphs_aligned(tr.apply_transforms(tr.get("pna"), _graphs(ts)), window=W,
                                    **CAPS)
    for layout, key in (("local", "loc_window"), (True, "blk_window")):
        batch = tb.to_device(tb.as_batch(packed, blocked=layout), "cpu")
        assert key in batch
        np.testing.assert_allclose(fwd(p, batch, tn.FLOAT32)[:G].numpy(), whole[:G].numpy(),
                                   rtol=1e-5, atol=1e-5)
    ell = dict(b["plain"], loc_ell=torch.zeros((W, 1), dtype=torch.int32))
    torch.testing.assert_close(fwd(p, ell, tn.FLOAT32), fwd(p, b["plain"], tn.FLOAT32))
    out, inter = fwd(p, b["plain"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3 and out.shape == (CAPS["graph_capacity"] + 1, 1)


@pytest.mark.parametrize("no_pool", [False, True], ids=["intermediates", "no_pool"])
def test_pna_layer_path_matches_jax(setup, no_pool, monkeypatch):
    """The no-spill per-layer slot path (one ``pna_local_layer`` launch per
    layer, row 20) against the JAX forward on the same batch, which runs its
    ``pna_local_layer`` in interpret mode: f32 to 1e-5 of each output's
    scale, predictions, every layer's h and the pooled h, with intermediates
    asked for and on a batch without ``pool_gl``; the whole-model kernel
    does not run."""
    from flowgnn_tpu_torch.ops import local_layer
    from test_torch_ell_layer import _close

    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    fwd, jfwd, params, b = setup
    drop = lambda batch: {k: v for k, v in batch.items() if not (no_pool and k == "pool_gl")}
    before = local_layer.pna_local_model.launches, local_layer.pna_local_layer.launches
    out, inter = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), drop(b["slot"]),
                     tn.FLOAT32, return_intermediates=True)
    want, want_inter = jfwd(jb.prepare_params(params, jn.FLOAT32), drop(b["jax_slot"]),
                            jn.FLOAT32, return_intermediates=True)
    assert local_layer.pna_local_model.launches == before[0]
    _close(out[:G].numpy(), np.asarray(want)[:G], 1e-5)
    assert len(inter["layers"]) == len(want_inter["layers"]) == 3
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        _close(got_l.numpy(), np.asarray(want_l), 1e-5)
    _close(inter["h_graph"][:G].numpy(), np.asarray(want_inter["h_graph"])[:G], 1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_segment_min_max_match_jax(dtype):
    """Seeded running min / max; an empty segment stays at its seed."""
    rng = np.random.default_rng(0)
    data = rng.normal(0, 20, (40, 3)).astype(dtype)
    ids = rng.integers(0, 6, 40).astype(np.int32)
    ids[ids == 4] = 5  # segment 4 stays empty
    for t_fn, j_fn, init in ((tseg.segment_min, jseg.segment_min, pna.MAX_INIT),
                             (tseg.segment_max, jseg.segment_max, pna.MIN_INIT)):
        got = t_fn(torch.from_numpy(data), torch.from_numpy(ids), 7, init).numpy()
        expect = np.asarray(j_fn(jnp.asarray(data), jnp.asarray(ids), 7, init))
        np.testing.assert_array_equal(got, expect)
        assert (got[4] == dtype(init)).all() and (got[6] == dtype(init)).all()


def test_load_pna_matches_jax(tmp_path):
    """The fseek offset map, on a file of np.arange floats; the synthetic
    set has the loader's keys and shapes; the 0-d avg_deg stays 0-d."""
    np.arange(325441, dtype="<f4").tofile(tmp_path / "pna_ep1_noBN_dim80.weights.all.bin")
    got, expect = tl.load_pna(str(tmp_path)), jl.load_pna(str(tmp_path))
    assert list(got) == list(expect)
    for k in expect:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], expect[k]), k
    synth = tl.synthetic_pna_params(0)
    assert {k: v.shape for k, v in synth.items()} == {k: v.shape for k, v in expect.items()}
    avg = tl.params_from_numpy(synth, tn.FLOAT32, "cpu")["avg_deg"]
    assert avg.shape == () and avg.item() == np.float32(tl.PNA_AVG_DEG)
