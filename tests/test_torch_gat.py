"""The port's GAT forward against the JAX package's, on the plain edge-list
batch (f64) and on the slot batch (f32) against each of the JAX package's
three GAT megakernels in interpret mode: the default two-window
``gat_local_model_pairs``, ``gat_local_model_slots`` (``FLOWGNN_GAT_PAIRS=0``)
and ``gat_local_model_dense`` (``FLOWGNN_GAT_DENSE=1``). They compute one
function, which the port's single kernel stands for. Also: the port's slot
path against its own plain path, and the weight loader against the JAX
loader. The graph set holds a one-node graph, whose only in-edge is its
self loop."""

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
CAPS = dict(node_capacity=511, edge_capacity=2048, graph_capacity=16)
G = 8
LONE = G - 1  # index of the one-node graph


def _graphs(syn):
    return syn.synthetic_molhiv(G - 1, seed=2) + [
        syn.random_molecule_graph(np.random.default_rng(9), num_nodes=1)
    ]


@pytest.fixture(scope="module")
def setup():
    params = tl.synthetic_gat_params(4, dim=16, heads=2, layers=3)
    jgs = jr.apply_transforms(jr.get("gat"), _graphs(js))
    tgs = tr.apply_transforms(tr.get("gat"), _graphs(ts))
    assert tgs[LONE].num_nodes == 1 and tgs[LONE].num_edges == 1
    batches = dict(
        jax_plain=jb.as_batch(jg.pack_graphs(jgs, **CAPS)),
        jax_slot=jb.as_batch(jg.pack_graphs_aligned(jgs, window=W, **CAPS),
                             blocked="local_slots", window=W),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **CAPS)), "cpu"),
        slot=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=W, **CAPS),
                                      blocked="local_slots", window=W), "cpu"),
    )
    return tr.get("gat").forward, jr.get("gat").forward, params, batches


def test_gat_plain_and_slot_f64(setup):
    fwd, jfwd, params, b = setup
    p64 = tl.params_from_numpy(params, tn.FLOAT64, "cpu")
    # Plain edge-list path, f64: the same math in another framework.
    plain = fwd(p64, b["plain"], tn.FLOAT64)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT64), b["jax_plain"], jn.FLOAT64))
    assert plain.dtype == torch.float64 and plain.shape == expect.shape
    assert np.ptp(expect[:G]) > 1e-3  # the predictions differ between graphs
    np.testing.assert_allclose(plain[:G].numpy(), expect[:G], rtol=1e-9, atol=1e-9)
    # The port's slot path (plain version of the kernel) equals its own
    # plain path.
    slot = fwd(p64, b["slot"], tn.FLOAT64)
    np.testing.assert_allclose(slot[:G].numpy(), plain[:G].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("env", [
    {}, {"FLOWGNN_GAT_PAIRS": "0"}, {"FLOWGNN_GAT_DENSE": "1"},
], ids=["pairs", "slots", "dense"])
def test_gat_slot_f32_matches_each_jax_kernel(setup, monkeypatch, env):
    """In f32 the three JAX kernels differ from the port only in summation
    order (the fused-glue scores of ``gat_local_model_slots`` compose
    proj·a before the product, one more rounding): 1e-5 for each."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fwd, jfwd, params, b = setup
    got = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), b["slot"], tn.FLOAT32)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), b["jax_slot"], jn.FLOAT32))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)


def test_gat_slot_pstack_is_live(setup):
    """Dead-wiring guard: corrupting the prefix source stack changes the
    output."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    good = fwd(p, b["slot"], tn.FLOAT32)
    corrupt = dict(b["slot"])
    src = corrupt["slot_pstack"].clone()
    src[src < W] = 0  # every source → the window's first row
    corrupt["slot_pstack"] = src
    bad = fwd(p, corrupt, tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-5, atol=1e-5)


def test_gat_unported_cases_raise(setup):
    """A slot batch the megakernel does not take (``return_intermediates``,
    no ``pool_gl``) runs the per-layer slot path, ``gat_local_message_slots``
    (kernel table row 21), as the JAX package does, and gives the
    megakernel's predictions; so does an ELL batch, which raised before the
    per-layer ELL kernels were ported and now runs
    ``gat_local_message_ell`` (row 17); the legacy dynamic-window and
    edge-block layouts, which raised before they were ported, run the plain
    loop (the latter through the windowed scatter, row 24)."""
    fwd, _, params, b = setup
    p = tl.params_from_numpy(params, tn.FLOAT32, "cpu")
    whole = fwd(p, b["slot"], tn.FLOAT32)
    per_layer, inter = fwd(p, b["slot"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3
    no_pool = {k: v for k, v in b["slot"].items() if k != "pool_gl"}
    ell = tb.to_device(tb.as_batch(tg.pack_graphs_aligned(
        tr.apply_transforms(tr.get("gat"), _graphs(ts)), window=W, **CAPS),
        blocked="local_ell", window=W, block=512), "cpu")
    for got in (per_layer, fwd(p, no_pool, tn.FLOAT32), fwd(p, ell, tn.FLOAT32)):
        np.testing.assert_allclose(got[:G].numpy(), whole[:G].numpy(), rtol=1e-5, atol=1e-5)
    packed = tg.pack_graphs_aligned(tr.apply_transforms(tr.get("gat"), _graphs(ts)), window=W,
                                    **CAPS)
    for layout, key in (("local", "loc_window"), (True, "blk_window")):
        batch = tb.to_device(tb.as_batch(packed, blocked=layout), "cpu")
        assert key in batch
        np.testing.assert_allclose(fwd(p, batch, tn.FLOAT32)[:G].numpy(), whole[:G].numpy(),
                                   rtol=1e-5, atol=1e-5)
    out, inter = fwd(p, b["plain"], tn.FLOAT32, return_intermediates=True)
    assert len(inter["layers"]) == 3 and out.shape == (CAPS["graph_capacity"] + 1, 1)


def test_load_gat_matches_jax(tmp_path):
    """The per-file layout with layer 0's zero padding, on files of
    np.arange floats; the synthetic set has the loader's keys, shapes and
    layer-0 zero pattern."""
    L, H, D = 5, 4, 16
    counts = {"linear_proj_weight_0": H * D * 9, "skip_proj_weight_0": H * D * 9,
              "linear_proj_weight_1": (L - 1) * (H * D) ** 2,
              "skip_proj_weight_1": (L - 1) * (H * D) ** 2,
              "scoring_fn_source": L * H * D, "scoring_fn_target": L * H * D,
              "pred_weights": D, "pred_bias": 1}
    for i, (name, count) in enumerate(counts.items()):
        values = 1 + 1000 * i + np.arange(count, dtype="<f4")  # no zero entry
        values.tofile(tmp_path / f"gat_ep1_{name}_layer{L}.bin")
    got, expect = tl.load_gat(str(tmp_path)), jl.load_gat(str(tmp_path))
    assert list(got) == list(expect)
    for k in expect:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], expect[k]), k
    synth = tl.synthetic_gat_params(0)
    assert {k: v.shape for k, v in synth.items()} == {k: v.shape for k, v in expect.items()}
    for k in ("proj_w", "skip_w"):
        assert np.array_equal(synth[k][0] != 0, expect[k][0] != 0), k
