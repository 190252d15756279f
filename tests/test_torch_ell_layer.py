"""The per-layer ELL path of GIN, GIN-VN and GCN and the ELL spill tail,
against the JAX package: the spilling ``local_ell`` layout key by key (the
JAX side through its numpy packer, ``FLOWGNN_NO_NATIVE=1``), the plain
versions of kernel table rows 13, 14 and 15 against the Pallas kernels in
interpret mode (row 11, row 13 at ``FLOWGNN_ELL_WPS=2``, too), and the
forward on every ELL batch the whole-model kernels do not take (a spill
tail, two edge blocks per window, no pooling layout, intermediates) against
the JAX forward and the port's plain path. PNA runs an ELL batch through its
plain loop, as the JAX package does."""

import warnings

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
from test_torch_cuda import ELL_LAYER_GEOMETRY, _ell_layer_operands, _port
from test_torch_local_layer import _jax_kernel
from test_torch_spill import _assert_batches_equal

G = 8  # graphs per forward-test bucket: 7 molhiv-shaped and one large
# Forward cases: (the large graph's nodes, window, block, pinned spill
# capacity). At W=128 a 300-node graph spans three windows, so its crossing
# edges ride the spill tail; blocks of 192 lanes need two per window; a
# capacity pinned on a bucket that spills nothing appends a tail of pad
# lanes with no blocked layout, which both packages sum by receiver.
CASES = {
    "spill": (300, 128, 384, None), "k2": (120, 128, 192, None),
    "no_pool": (120, 128, 384, None), "intermediates": (120, 128, 384, None),
    "pad_tail": (120, 128, 384, 1024),
}
SMALL = {
    "gin": lambda: loaders.synthetic_gin_params(4, dim=32, hidden=64, layers=2),
    "gcn": lambda: loaders.synthetic_gcn_params(4, dim=32, layers=2),
    "pna": lambda: loaders.synthetic_pna_params(4, dim=32, layers=2),
    "dgn": lambda: loaders.synthetic_dgn_params(4, dim=32, layers=2),
    "gat": lambda: loaders.synthetic_gat_params(4, dim=16, heads=2, layers=3),
}
# DGN and GAT take blocks of 512 lanes where the others take 384
# (``base.GEOMETRY_DEFAULTS``): GAT's self loops fill a window's lanes. Their
# cases scale each block by 4/3, so each keeps its k.
BLOCK_SCALE = {"dgn": (4, 3), "gat": (4, 3)}


def _quiet(fn, *args, **kw):
    """``fn`` with the k > 1 note silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def case_batches(name: str, case: str) -> dict:
    """The JAX ELL batch, the port's on the CPU and the port's plain batch
    of the same packing (same node rows), of one forward case, with the
    case's property checked."""
    big, window, block, capacity = CASES[case]
    num, den = BLOCK_SCALE.get(name, (1, 1))
    block = block * num // den
    graph = lambda mod: mod.random_molecule_graph(np.random.default_rng(3), num_nodes=big)
    jgs = jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G - 1, seed=2) + [graph(js)])
    tgs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G - 1, seed=2) + [graph(ts)])
    caps = dict(node_capacity=1023, edge_capacity=4096, graph_capacity=16,
                with_eigen=tr.get(name).needs_eigen)
    ell = dict(blocked="local_ell", window=window, block=block, spill_capacity=capacity)
    packed = tg.pack_graphs_aligned(tgs, window=window, **caps)
    jbatch = _quiet(jb.as_batch, jg.pack_graphs_aligned(jgs, window=window, **caps), **ell)
    batch = _quiet(tb.as_batch, packed, **ell)
    if case == "no_pool":
        jbatch, batch = ({k: v for k, v in b.items() if k != "pool_gl"} for b in (jbatch, batch))
    _assert_batches_equal(jbatch, batch)
    spill, k = tb.ell_spill_lanes(batch), tb.ell_geometry(batch)[1]
    assert (spill > 0) == (case in ("spill", "pad_tail")) and k == (2 if case == "k2" else 1)
    assert ("spill_blk_vlocal" in batch) == (case == "spill")
    assert ("pool_gl" in batch) == (case != "no_pool")
    return dict(jax=jbatch, ell=tb.to_device(batch, "cpu"),
                plain=tb.to_device(tb.as_batch(packed), "cpu"))


def _jax_forward(name: str, params: dict, batch: dict, **kw):
    """The JAX forward in f32 with its intermediates, as numpy."""
    out, inter = jr.get(name).forward(jb.prepare_params(params, jn.FLOAT32), batch, jn.FLOAT32,
                                      return_intermediates=True, **kw)
    return np.asarray(out), [np.asarray(x) for x in inter["layers"]], np.asarray(inter["h_graph"])


def _close(got, want, tol: float) -> None:
    """|got − want| ≤ tol·(scale + |want|), scale the largest |want| (at
    least 1): intermediates reach tens where the predictions stay below 1."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=tol, atol=tol)


def check_forward_matches_jax(name: str, case: str, b: dict) -> None:
    """The port's forward on ``b["ell"]`` against the JAX forward on the same
    batch (Pallas in interpret mode), f32 to 1e-5: predictions, every
    layer's h and the pooled h, with and without ``return_intermediates``."""
    params = SMALL[name.split("-")[0]]()
    kw = dict(fpga_eps=name == "gin") if name.startswith("gin") else {}
    p32 = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    fwd = tr.get(name).forward
    out, inter = fwd(p32, b["ell"], tn.FLOAT32, return_intermediates=True, **kw)
    want, layers, h_graph = _jax_forward(name, params, b["jax"], **kw)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert np.ptp(want[:G]) > 1e-4 and np.isfinite(want).all()
    _close(out[:G].numpy(), want[:G], 1e-5)
    assert len(inter["layers"]) == len(layers)
    for got_l, want_l in zip(inter["layers"], layers):
        _close(got_l.numpy(), want_l, 1e-5)
    _close(inter["h_graph"][:G].numpy(), h_graph[:G], 1e-5)
    if case != "intermediates":  # the same per-layer path without them
        np.testing.assert_array_equal(fwd(p32, b["ell"], tn.FLOAT32, **kw).numpy(), out.numpy())


@pytest.mark.parametrize("geometry,block", [(128, 384), (512, 128)], ids=["W128", "W512"])
def test_spilling_ell_layout_equals_jax(geometry, block, monkeypatch):
    """Every bucket of a stream whose every bucket spills (24 hep10k-shaped
    graphs and one of 400 nodes: at W=128 it crosses windows, at W=512 with
    blocks of 128 lanes its windows overflow k=4 blocks), from
    ``as_batches_uniform`` (spill capacity reconciled) and from ``as_batch``,
    equals the JAX package's: the spill lanes after the P ELL lanes, in the
    blocked order of the spill scatter, the degrees over every lane."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    big = lambda mod: mod.random_molecule_graph(np.random.default_rng(1), num_nodes=400)
    jgs = js.synthetic_dataset("hep10k", seed=5, num_graphs=24) + [big(js)]
    tgs = ts.synthetic_dataset("hep10k", seed=5, num_graphs=24) + [big(ts)]
    cap = 2047
    kw = dict(node_capacity=cap, edge_capacity=jg.auto_edge_capacity(jgs, cap), graph_capacity=16,
              align_window=geometry)
    jbuckets, tbuckets = list(jg.pack_dataset(jgs, **kw)), list(tg.pack_dataset(tgs, **kw))
    ell = dict(blocked="local_ell", window=geometry, block=block)
    tbatches = _quiet(tb.as_batches_uniform, tbuckets, **ell)
    jbatches = _quiet(jb.as_batches_uniform, jbuckets, **ell)
    assert len(tbatches) == len(jbatches) >= 2
    for jp, tp, a, b in zip(jbuckets, tbuckets, jbatches, tbatches):
        _assert_batches_equal(a, b)
        _assert_batches_equal(_quiet(jb.as_batch, jp, **ell), _quiet(tb.as_batch, tp, **ell))
        p, n = b["loc_ulocal"].shape[0], b["node_feat"].shape[0]
        assert tb.ell_spill_lanes(b) == b["spill_blk_vlocal"].shape[0] > 0
        real = b["receivers"][p:] < n - 1
        assert np.array_equal(b["spill_blk_vlocal"][real], b["receivers"][p:][real] % 512)
        assert (b["spill_blk_vlocal"][~real] == 512).all()


@pytest.mark.parametrize("kernel,final", [
    ("gin_local_layer_ell", False), ("gin_local_layer_ell", True),
    ("gcn_local_message_ell", False), ("gcn_local_layer_ell", False),
    ("gcn_local_layer_ell", True),
], ids=["row13", "row13-final", "row14", "row15", "row15-final"])
@pytest.mark.parametrize("geometry", ["W128", "k2"])
def test_ell_layer_ref_matches_jax(kernel, final, geometry, monkeypatch):
    """The plain versions of rows 13 (nonzero ``m_spill``), 14 and 15, on a
    layer and the last layer, at k=1 and k=2, against the Pallas kernels in
    interpret mode, f32 to 1e-5 of the output's scale (summation order
    only)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _ell_layer_operands(kernel, geometry, final)
    got = getattr(local_layer, kernel)(**_port(ops, "cpu"))
    expect = _jax_kernel(kernel, _jax_operands(kernel, ops, ELL_LAYER_GEOMETRY[geometry][2]))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2
    _close(got.numpy(), expect, 1e-5)


def _jax_operands(kernel: str, ops: dict, k: int, wps: int = 1) -> dict:
    """The port's operands of a per-layer ELL kernel in the JAX kernel's
    argument forms."""
    meta = ops["ell_meta"]
    lanes = dict(edge_attr=meta[:, 2:].copy(), u_local=meta[:, 0].copy(),
                 v_local=meta[:, 1].copy(), window=ops["window"], k_blocks=k)
    if kernel == "gin_local_layer_ell":
        return dict(lanes, ee=None, ee_table=ops["ee_table"], h=ops["h"], m_spill=ops["m_spill"],
                    **{w: ops[w] for w in ("w1", "b1", "w2", "b2", "eps1", "final_relu")}, wps=wps)
    common = dict(lanes, ee_table=ops["ee_table"], h=ops["h"], dis=ops["dis"])
    if kernel == "gcn_local_message_ell":
        return common
    row = lambda x: None if x is None else x[None, :]
    return dict(common, root=row(ops["root"]), alpha=row(ops["alpha"]), beta=row(ops["beta"]),
                w_next=ops["w_next"], b_next=row(ops["b_next"]))


@pytest.mark.parametrize("final", [False, True], ids=["layer", "final"])
def test_row11_wps_merges_into_row13(final, monkeypatch):
    """Kernel table row 11, ``_local_scatter_apply_ell_wps``, is row 13 with
    ``wps`` windows per grid step: at ``FLOWGNN_ELL_WPS=2`` the JAX GIN
    layer runs it, and it equals the port's ``gin_local_layer_ell_ref``."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_ELL_WPS", "2")
    wps = jb.ell_wps("gin")
    assert wps == 2
    ops = _ell_layer_operands("gin_local_layer_ell", "W128", final)
    got = local_layer.gin_local_layer_ell_ref(**_port(ops, "cpu"))
    expect = _jax_kernel("gin_local_layer_ell", _jax_operands("gin_local_layer_ell", ops, 1, wps))
    _close(got.numpy(), expect, 1e-5)


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn"])
@pytest.mark.parametrize("case", list(CASES))
def test_ell_layer_forward_matches_jax_and_plain(name, case, monkeypatch):
    """The per-layer ELL path against the JAX forward (f32, 1e-5: outputs
    and every intermediate) and against the port's plain edge-list path in
    f64 (1e-9: predictions, pooled h and every layer's rows of real nodes;
    the pad node's row differs, as the plain path's pad edges land there).
    GIN-VN runs with the trained ε. The whole-model kernels do not run."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = case_batches(name, case)
    before = (local_layer.gin_local_model.launches, local_layer.gcn_local_model.launches)
    check_forward_matches_jax(name, case, b)

    kw = dict(fpga_eps=name == "gin") if name.startswith("gin") else {}
    p64 = loaders.params_from_numpy(SMALL[name.split("-")[0]](), tn.FLOAT64, "cpu")
    fwd = tr.get(name).forward
    out, inter = fwd(p64, b["ell"], tn.FLOAT64, return_intermediates=True, **kw)
    want, want_inter = fwd(p64, b["plain"], tn.FLOAT64, return_intermediates=True, **kw)
    assert out.dtype == torch.float64
    real = b["ell"]["node_graph"] < G
    np.testing.assert_allclose(out[:G].numpy(), want[:G].numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(inter["h_graph"][:G].numpy(), want_inter["h_graph"][:G].numpy(),
                               rtol=1e-9, atol=1e-9)
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        np.testing.assert_allclose(got_l[real].numpy(), want_l[real].numpy(), rtol=1e-9, atol=1e-9)
    assert (local_layer.gin_local_model.launches, local_layer.gcn_local_model.launches) == before


def test_ell_spill_tail_is_live():
    """Dead-wiring guard: routing the spill tail's lanes to the pad node
    changes GIN's and GCN's output."""
    for name in ("gin", "gcn"):
        b = case_batches(name, "spill")
        p = loaders.params_from_numpy(SMALL[name](), tn.FLOAT32, "cpu")
        good = tr.get(name).forward(p, b["ell"], tn.FLOAT32)
        pl = b["ell"]["loc_ulocal"].shape[0]
        recv = b["ell"]["receivers"].clone()
        recv[pl:] = b["ell"]["node_feat"].shape[0] - 1
        vloc = torch.full_like(b["ell"]["spill_blk_vlocal"], 512)
        cut = dict(b["ell"], receivers=recv, spill_blk_vlocal=vloc)
        bad = tr.get(name).forward(p, cut, tn.FLOAT32)
        assert not torch.allclose(bad[:G], good[:G], rtol=1e-4, atol=1e-4), name


def test_pna_ell_matches_jax(monkeypatch):
    """PNA has no ELL kernel: an ELL batch with a spill tail runs the plain
    loop in both packages; f32 to 1e-5 against the JAX forward, outputs and
    intermediates, and f64 to 1e-9 against the port's plain batch."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = case_batches("pna", "spill")
    check_forward_matches_jax("pna", "spill", b)
    p64 = loaders.params_from_numpy(SMALL["pna"](), tn.FLOAT64, "cpu")
    fwd = tr.get("pna").forward
    np.testing.assert_allclose(fwd(p64, b["ell"], tn.FLOAT64)[:G].numpy(),
                               fwd(p64, b["plain"], tn.FLOAT64)[:G].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["gin", "gcn"])
@pytest.mark.parametrize("case", list(CASES))
def test_ell_dispatch_runs_the_jax_rows(name, case, monkeypatch):
    """Each ELL forward case calls the kernels the JAX dispatch runs, once
    per layer: GIN row 13; GCN row 15 with no spill tail, and with one row 14
    and the spill scatter (row 24; a tail of pad lanes only sums by
    receiver), never row 15 (which the port once named for a spill tail); no
    whole-model kernel."""
    from flowgnn_tpu_torch.models import base as tbase
    from flowgnn_tpu_torch.models import gcn, gin

    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    for mod, fn_name in ((gin, "gin_local_layer_ell"), (gin, "gin_local_model"),
                         (gcn, "gcn_local_layer_ell"), (gcn, "gcn_local_message_ell"),
                         (gcn, "gcn_local_model"), (tbase, "windowed_segment_sum")):
        counted(mod, fn_name)
    b = case_batches(name, case)
    p = loaders.params_from_numpy(SMALL[name](), tn.FLOAT32, "cpu")
    tr.get(name).forward(p, b["ell"], tn.FLOAT32, return_intermediates=case == "intermediates")
    L = 2
    if name == "gin":
        want = {"gin_local_layer_ell": L}
    else:
        tail = case in ("spill", "pad_tail")
        want = {"gcn_local_message_ell": L} if tail else {"gcn_local_layer_ell": L}
    if case == "spill":
        want["windowed_segment_sum"] = L
    assert calls == want
