"""The port's ELL slice against the JAX package's: the ``local_ell`` host
layout (the JAX side through its numpy packer, ``FLOWGNN_NO_NATIVE=1``),
the whole-model ELL kernels' plain versions against the Pallas kernels in
interpret mode, the GIN / GIN-VN / GCN ELL branches against the JAX forward
and against the port's own plain path, at W=128 and at W=512 with a 400-node
graph, and the ELL batches the whole-model kernels do not take, which run
the per-layer ELL path (tests/test_torch_ell_layer.py holds it in full)."""

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
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import _ell_operands, _port
from test_torch_host import _assert_batches_equal
from test_torch_local_layer import _jax_kernel

G = 8  # graphs per model-test bucket: 7 molhiv-shaped and one large


def _stream(profile: str):
    """(JAX graphs, port graphs, node capacity): 40 molhiv-shaped graphs, or
    24 hep10k-shaped graphs and one of 400 nodes."""
    jgs = js.synthetic_dataset(profile, seed=5, num_graphs=40 if profile == "molhiv" else 24)
    tgs = ts.synthetic_dataset(profile, seed=5, num_graphs=len(jgs))
    if profile == "molhiv":
        return jgs, tgs, 383
    big = lambda mod: mod.random_molecule_graph(np.random.default_rng(1), num_nodes=400)
    return jgs + [big(js)], tgs + [big(ts)], 2047


@pytest.mark.parametrize("profile,geometry", [("molhiv", (128, 384)), ("hep10k", (512, 1536))])
def test_ell_layouts_equal(profile, geometry, monkeypatch):
    """Every bucket's ``local_ell`` arrays equal the JAX package's, k=1 and
    no spill; within each window the lanes ascend by destination row, which
    the CUDA kernels' binary search relies on."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    jgs, tgs, cap = _stream(profile)
    window, block = tb.choose_geometry("gin", max(g.num_nodes for g in tgs))
    assert (window, block) == geometry
    assert jb.choose_window("gin", max(g.num_nodes for g in jgs), 128) == window
    edge_cap = jg.auto_edge_capacity(jgs, cap)
    kw = dict(node_capacity=cap, edge_capacity=edge_cap, graph_capacity=16, align_window=window)
    jbuckets = list(jg.pack_dataset(jgs, **kw))
    tbuckets = list(tg.pack_dataset(tgs, **kw))
    jbatches = jb.as_batches_uniform(jbuckets, blocked="local_ell", window=window, block=block)
    tbatches = tb.as_batches_uniform(tbuckets, blocked="local_ell", window=window, block=block)
    assert len(jbatches) == len(tbatches) >= 2
    for a, b in zip(jbatches, tbatches):
        _assert_batches_equal(a, b)
        assert tb.ell_geometry(b) == (window, 1)
        assert b["senders"].shape == b["loc_ulocal"].shape  # no spill lanes
        assert (np.diff(b["loc_vlocal"].reshape(-1, block), axis=1) >= 0).all()


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn"])
@pytest.mark.parametrize("big", [120, 400], ids=["W128", "W512"])
def test_ell_kernel_matches_jax(name, big, monkeypatch):
    """``gin_local_model_ref`` (with and without ``vn_col``) and
    ``gcn_local_model_ref`` against the Pallas kernels in interpret mode."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    kernel = "gcn_local_model" if name == "gcn" else "gin_local_model"
    ops = _ell_operands(name, big)
    meta = ops.pop("ell_meta")
    expect = _jax_kernel(kernel, dict(
        ops, edge_attr=meta[:, 2:].copy(), u_local=meta[:, 0].copy(), v_local=meta[:, 1].copy(),
    ))
    got = getattr(local_layer, kernel)(**_port(dict(ops, ell_meta=meta), "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def _model_setup(name: str, big: int):
    """(port forward, JAX forward, numpy params, batches) over 7 molhiv-shaped
    graphs and one of ``big`` nodes, at the window their largest graph gets."""
    base_name = name.split("-")[0]
    params = (loaders.synthetic_gcn_params(4, dim=32, layers=2) if base_name == "gcn"
              else loaders.synthetic_gin_params(4, dim=32, hidden=64, layers=2))
    big_graph = lambda mod: mod.random_molecule_graph(np.random.default_rng(3), num_nodes=big)
    jgs = jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G - 1, seed=2) + [big_graph(js)])
    tgs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G - 1, seed=2) + [big_graph(ts)])
    window, block = tb.choose_geometry(name, max(g.num_nodes for g in tgs))
    caps = dict(node_capacity=4 * window - 1, edge_capacity=4096, graph_capacity=16)
    ell = dict(blocked="local_ell", window=window, block=block)
    batches = dict(
        jax_ell=jb.as_batch(jg.pack_graphs_aligned(jgs, window=window, **caps), **ell),
        ell=tb.to_device(tb.as_batch(tg.pack_graphs_aligned(tgs, window=window, **caps), **ell), "cpu"),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **caps)), "cpu"),
    )
    return tr.get(name).forward, jr.get(name).forward, params, batches


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn"])
@pytest.mark.parametrize("big", [120, 400], ids=["W128", "W512"])
def test_ell_forward_matches_jax_and_plain(name, big, monkeypatch):
    """The ELL branch in f32 against the JAX forward on the same batch (its
    ``gin_local_model`` / ``gcn_local_model`` in interpret mode), and in f64
    against the port's plain edge-list path: another layout, the same sums.
    GIN-VN runs with the trained ε, so the (1+ε)·h term is checked too."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    fwd, jfwd, params, b = _model_setup(name, big)
    kw = {} if name == "gcn" else dict(fpga_eps=name == "gin")
    got = fwd(loaders.params_from_numpy(params, tn.FLOAT32, "cpu"), b["ell"], tn.FLOAT32, **kw)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), b["jax_ell"], jn.FLOAT32, **kw))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:G].numpy(), expect[:G], rtol=1e-5, atol=1e-5)

    p64 = loaders.params_from_numpy(params, tn.FLOAT64, "cpu")
    ell = fwd(p64, b["ell"], tn.FLOAT64, **kw)
    plain = fwd(p64, b["plain"], tn.FLOAT64, **kw)
    assert ell.dtype == torch.float64
    np.testing.assert_allclose(ell[:G].numpy(), plain[:G].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,row", [("gin", 13), ("gcn", 15)])
@pytest.mark.parametrize("case", ["k2", "spill", "no_pool", "intermediates"])
def test_ell_batches_without_the_kernel_raise(name, row, case, monkeypatch):
    """An ELL batch the whole-model kernel does not take (two edge blocks
    per window, a real spill tail, more than POOL_GMAX graphs in a window,
    or intermediates asked for) no longer raises: it runs the per-layer ELL
    path (GIN row 13; GCN row 15, or row 14 with the spill scatter, row 24,
    on a spill tail) and matches the JAX forward, f32 to 1e-5, predictions
    and every intermediate; no whole-model kernel launches."""
    from test_torch_ell_layer import case_batches, check_forward_matches_jax

    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = case_batches(name, case)
    assert not tb.ell_megakernel(b["ell"], case == "intermediates")
    before = (local_layer.gin_local_model.launches, local_layer.gcn_local_model.launches)
    check_forward_matches_jax(name, case, b)
    assert (local_layer.gin_local_model.launches, local_layer.gcn_local_model.launches) == before
