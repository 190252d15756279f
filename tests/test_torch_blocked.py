"""The edge-block layout (``as_batch(blocked=True)``, ``--layout blocked``)
against the JAX package: the numpy layout functions and the batch key by key (empty
windows, the blocks left over parked on the last window), the windowed
scatter on that layout (kernel table row 24 at windows of 128 rows, the
models' four reduction widths) and the fused GIN layer (row 25) against the
Pallas kernels in interpret mode, and every model's forward on an edge-block
batch against the JAX forward, against the port's plain path, and against
the kernels the JAX dispatch runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu.core import blocking as jblk
from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch.core import blocking as tblk
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import fused_layer, spmm
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import _blocked_wss_operands, _gin_blocks_operands, _port
from test_torch_ell_layer import SMALL, _close, _jax_forward
from test_torch_spill import _assert_batches_equal

G = 8
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
CAPS = dict(node_capacity=1023, edge_capacity=2048, graph_capacity=16)


def _packed(name: str):
    """(JAX, port) unaligned packing of 8 molhiv-shaped graphs for model
    ``name``: graphs straddle the 128-row windows and the bucket's trailing
    windows hold no edge."""
    jgs = jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G, seed=6))
    tgs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G, seed=6))
    eig = tr.get(name).needs_eigen
    return (jg.pack_graphs(jgs, with_eigen=eig, **CAPS), tg.pack_graphs(tgs, with_eigen=eig, **CAPS))


def _batches(name: str) -> dict:
    jp, tp = _packed(name)
    jbatch, batch = jb.as_batch(jp, blocked=True), tb.as_batch(tp, blocked=True)
    _assert_batches_equal(jbatch, batch)
    return dict(jax=jbatch, blocked=tb.to_device(batch, "cpu"),
                plain=tb.to_device(tb.as_batch(tp), "cpu"))


def test_edge_block_layout_functions_equal_jax():
    """``build_edge_blocks``, ``apply_blocking``, ``blocks_capacity`` and the
    numpy oracle ``segment_sum_blocked_reference`` equal the JAX package's on
    a bucket with empty windows; every window owns at least one block and the
    blocks left over sit on the last window, all sentinel lanes."""
    jp, tp = _packed("gin")
    n = tp.node_capacity + 1
    args = (n, tp.edge_capacity)
    a, b = jblk.build_edge_blocks(jp.receivers, *args), tblk.build_edge_blocks(tp.receivers, *args)
    for f in ("perm", "valid", "v_local", "block_window"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.window, a.block, a.num_blocks) == (b.window, b.block, b.num_blocks)
    nw = -(-n // 128)
    assert b.num_blocks == tblk.blocks_capacity(tp.edge_capacity, n, 128, 128) \
        == jblk.blocks_capacity(jp.edge_capacity, n, 128, 128) == -(-tp.edge_capacity // 128) + nw
    assert set(b.block_window) == set(range(nw)) and (np.diff(b.block_window) >= 0).all()
    empty = [w for w in range(nw - 1) if not b.valid.reshape(-1, 128)[b.block_window == w].any()]
    assert empty, "no empty window in the bucket"
    parked = b.valid.reshape(-1, 128)[b.block_window == nw - 1]
    assert parked.shape[0] > 1 and not parked[1:].any()
    for x, y in zip(jblk.apply_blocking(a, jp.senders, jp.receivers, jp.edge_attr, n - 1),
                    tblk.apply_blocking(b, tp.senders, tp.receivers, tp.edge_attr, n - 1)):
        assert np.array_equal(x, y)
    vals = np.random.default_rng(0).normal(size=(tp.edge_capacity, 5)).astype(np.float32)
    want = jblk.segment_sum_blocked_reference(vals, a, n)
    np.testing.assert_array_equal(tblk.segment_sum_blocked_reference(vals, b, n), want)
    direct = np.zeros((n, 5), np.float32)
    real = tp.receivers < n - 1
    np.add.at(direct, tp.receivers[real], vals[real])
    np.testing.assert_allclose(want[: n - 1], direct[: n - 1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_edge_block_batch_equals_jax(name):
    """``as_batch(blocked=True)`` equals the JAX package's key by key for
    every model (no degrees, no pool layout; eigenvectors and the VN mask
    pass through), from ``as_batches_uniform`` too."""
    jp, tp = _packed(name)
    batch = tb.as_batch(tp, blocked=True)
    _assert_batches_equal(jb.as_batch(jp, blocked=True), batch)
    assert "in_deg" not in batch and "pool_gl" not in batch
    assert batch["blk_vlocal"].shape[0] == batch["senders"].shape[0]
    assert batch["blk_vlocal"].dtype == batch["blk_window"].dtype == np.int32
    for a, b in zip(jb.as_batches_uniform([jp, jp], blocked=True),
                    tb.as_batches_uniform([tp, tp], blocked=True)):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("width", [68, 100, 160, 200])
def test_segment_sum_blocked_matches_jax(width, monkeypatch):
    """``segment_sum_blocked`` (row 24 over every 128-row window of the
    edge-block layout) at each model's reduction width against the Pallas
    kernel in interpret mode, f32 to 1e-5; pad lanes carry values that the
    sentinel keeps out."""
    from flowgnn_tpu.ops.pallas.spmm import segment_sum_blocked as jax_blocked

    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _blocked_wss_operands(width)
    n = ops["num_windows"] * 128 - 1
    t = _port(ops, "cpu")
    before = spmm.windowed_segment_sum.launches
    got = spmm.segment_sum_blocked(t["values"], t["v_local"][:, 0], t["block_window"], n, 128)
    assert spmm.windowed_segment_sum.launches == before  # a CPU tensor counts nothing
    want = np.asarray(jax_blocked(jnp.asarray(ops["values"]), jnp.asarray(ops["v_local"][:, 0]),
                                  jnp.asarray(ops["block_window"]), n, 128))
    assert got.shape == want.shape == (n, width) and np.abs(want).max() > 1e-2
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("final", [False, True], ids=["layer", "final"])
def test_gin_layer_fused_ref_matches_jax(final, monkeypatch):
    """Row 25's plain version against the Pallas ``gin_layer_fused`` in
    interpret mode, a layer and the last layer, f32 to 1e-5."""
    from flowgnn_tpu.ops.pallas.fused_layer import gin_layer_fused as jax_fused

    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gin_blocks_operands("gin_layer_fused", final=final)
    got = fused_layer.gin_layer_fused(**_port(ops, "cpu"))
    want = np.asarray(jax_fused(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                   for k, v in ops.items()}))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 1e-2 and (want.min() < 0) == final
    _close(got.numpy(), want, 1e-5)


def _kw(name: str) -> dict:
    return dict(fpga_eps=name == "gin") if name.startswith("gin") else {}


def _check_forward(name: str, b: dict, tol64: float, **kw) -> None:
    """The port's forward on the edge-block batch against the JAX forward on
    the same batch (f32 1e-5, every intermediate) and against the port's
    plain path in f64 (``tol64``; the edge-block order re-orders the edge
    axis only, so every node row compares)."""
    params = SMALL[name.split("-")[0]]()
    fwd = tr.get(name).forward
    p32 = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    out, inter = fwd(p32, b["blocked"], tn.FLOAT32, return_intermediates=True, **_kw(name), **kw)
    want, layers, h_graph = _jax_forward(name, params, b["jax"], **_kw(name), **kw)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert np.ptp(want[:G]) > 1e-4 and np.isfinite(want).all()
    _close(out[:G].numpy(), want[:G], 1e-5)
    assert len(inter["layers"]) == len(layers)
    for got_l, want_l in zip(inter["layers"], layers):
        _close(got_l.numpy(), want_l, 1e-5)
    _close(inter["h_graph"][:G].numpy(), h_graph[:G], 1e-5)

    p64 = loaders.params_from_numpy(params, tn.FLOAT64, "cpu")
    out, inter = fwd(p64, b["blocked"], tn.FLOAT64, return_intermediates=True, **_kw(name), **kw)
    want, want_inter = fwd(p64, b["plain"], tn.FLOAT64, return_intermediates=True, **_kw(name))
    real = b["plain"]["node_graph"] < G
    np.testing.assert_allclose(out[:G].numpy(), want[:G].numpy(), rtol=tol64, atol=tol64)
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        np.testing.assert_allclose(got_l[real].numpy(), want_l[real].numpy(), rtol=tol64,
                                   atol=tol64)


@pytest.mark.parametrize("name", MODELS)
def test_edge_block_forward_matches_jax_and_plain(name, monkeypatch):
    """All six models on an edge-block batch: the plain loop with row 24 as
    the reduction (PNA, GCN and DGN compute their degrees, which the layout
    does not attach), f32 1e-5 against JAX, f64 1e-9 against the plain path
    (DGN 1e-6)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    _check_forward(name, _batches(name), 1e-6 if name == "dgn" else 1e-9)


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
def test_gin_fused_forward_matches_jax_and_plain(name, monkeypatch):
    """``fused=True``: GIN runs row 25 per layer; GIN-VN, whose virtual node
    the fused kernel has no operand for, runs the split path through row 24,
    as the JAX predicate decides."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    _check_forward(name, _batches(name), 1e-9, fused=True)


@pytest.mark.parametrize("name,fused", [(m, False) for m in MODELS]
                         + [("gin", True), ("gin-vn", True)])
def test_edge_block_dispatch_runs_the_jax_rows(name, fused, monkeypatch):
    """On an edge-block batch every model calls the windowed scatter once per
    layer and no other kernel; GIN with ``fused`` calls row 25 once per layer
    and the scatter never; GIN-VN with ``fused`` stays on the scatter. On a
    plain batch neither is called."""
    from flowgnn_tpu_torch.models import gin

    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    counted(spmm, "windowed_segment_sum")
    for k in ("gin_layer_fused", "gin_local_layer", "gin_local_layer_ell", "gin_local_model",
              "gin_local_model_slots"):
        counted(gin, k)
    b = _batches(name)
    params = SMALL[name.split("-")[0]]()
    L = {"gin": 2, "gin-vn": 2, "gcn": 2, "pna": 2, "dgn": 2, "gat": 3}[name]
    p = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    kw = dict(fused=True) if fused else {}
    tr.get(name).forward(p, b["blocked"], tn.FLOAT32, **kw)
    assert calls == ({"gin_layer_fused": L} if fused and name == "gin"
                     else {"windowed_segment_sum": L})
    calls.clear()
    tr.get(name).forward(p, b["plain"], tn.FLOAT32, **kw)
    assert calls == {}


@pytest.mark.parametrize("name,fused", [("gin", False), ("gin", True), ("gat", False),
                                        ("pna", False), ("dgn", False), ("gcn", False)])
@pytest.mark.parametrize("prec", [tn.FLOAT32, tn.BF16], ids=["f32", "bf16"])
def test_edge_block_operands_meet_the_kernel_contract(name, fused, prec):
    """What each model's edge-block path hands row 24 (or GIN's fused path
    row 25) is what the CUDA wrappers accept: contiguous tensors, int32
    lanes, values in the compute dtype at the model's reduction width."""
    from test_torch_cuda import _edge_block_batch

    batch = tb.to_device(_edge_block_batch(name), "cpu")
    params = loaders.params_from_numpy(SMALL[name](), prec, "cpu")
    mod = __import__(f"flowgnn_tpu_torch.models.{name}", fromlist=["x"])
    kw = dict(fused=True) if fused else {}
    kernels = mod.layer_kernel_operands(params, batch, prec, **kw)
    want = "gin_layer_fused" if fused else "windowed_segment_sum"
    assert set(kernels) == {want}
    ops = kernels[want]
    for k, v in ops.items():
        if torch.is_tensor(v):
            assert v.is_contiguous(), k
            ints = k in ("v_local", "block_window")
            assert v.dtype == (torch.int32 if ints else prec.compute_dtype
                               if k != "eps1" else torch.float32), k
    p = batch["blk_vlocal"].shape[0]
    d = 32  # the SMALL models' width (GAT: 2 heads × 16)
    width = {"gin": d, "gcn": d, "pna": 2 * d, "dgn": 2 * d, "gat": d + 2}[name]
    vals = ops["vals" if fused else "values"]
    assert vals.shape == (p, width)
    assert ops["v_local"].shape == ((p,) if fused else (p, 1))
    assert ops["window"] == 128 and ops["block_window"].shape[0] * 128 == p
