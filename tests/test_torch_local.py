"""The legacy dynamic-window local layout (``as_batch(blocked="local")``)
against the JAX package: ``build_local_blocks`` and the batch key by key
(with and without crossing edges, the fixed tail of 8192 lanes, the
``ValueError`` past it), the plain versions of kernel table rows 10
(``gin_local_layer``) and 12 (``gin_local_layer_ell`` with per-lane bond
embeddings) against the Pallas kernels in interpret mode, GIN's and GIN-VN's
forward through row 10 and the other models' plain loop on such a batch
against the JAX forward and the port's plain path, and the kernels each case
calls."""

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
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import ELL_LAYER_GEOMETRY, _gin_blocks_operands, _port
from test_torch_ell_layer import SMALL, _close, _jax_forward
from test_torch_local_layer import _jax_kernel
from test_torch_spill import _assert_batches_equal

G = 8
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
CAPS = dict(node_capacity=1023, edge_capacity=4096, graph_capacity=16)


def _packed(name: str, spill: bool):
    """(JAX, port) window-aligned packing at W=128 of 7 molhiv-shaped graphs
    and one of 120 nodes, or with ``spill`` of 300 (it spans three windows,
    so its crossing edges ride the spill tail)."""
    big = lambda mod: mod.random_molecule_graph(np.random.default_rng(3),
                                                num_nodes=300 if spill else 120)
    jgs = jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G - 1, seed=2) + [big(js)])
    tgs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G - 1, seed=2) + [big(ts)])
    kw = dict(CAPS, window=128, with_eigen=tr.get(name).needs_eigen)
    return jg.pack_graphs_aligned(jgs, **kw), tg.pack_graphs_aligned(tgs, **kw)


def _batches(name: str, spill: bool) -> dict:
    jp, tp = _packed(name, spill)
    jbatch, batch = jb.as_batch(jp, blocked="local"), tb.as_batch(tp, blocked="local")
    _assert_batches_equal(jbatch, batch)
    p, n = batch["loc_ulocal"].shape[0], batch["node_feat"].shape[0]
    assert batch["senders"].shape[0] - p == tb.LOCAL_SPILL_CAPACITY == 8192
    assert bool((batch["receivers"][p:] < n - 1).any()) == spill
    return dict(jax=jbatch, local=tb.to_device(batch, "cpu"),
                plain=tb.to_device(tb.as_batch(tp), "cpu"))


@pytest.mark.parametrize("spill", [False, True], ids=["fits", "spill"])
def test_local_blocks_equal_jax(spill):
    """``build_local_blocks`` equals the JAX package's field by field; every
    window owns at least one block, the blocks left over sit on the last
    window, and the tail's lanes past the crossing edges hold edge 0."""
    jp, tp = _packed("gin", spill)
    n = tp.node_capacity + 1
    a = jblk.build_local_blocks(jp.senders, jp.receivers, n, jp.edge_capacity)
    b = tblk.build_local_blocks(tp.senders, tp.receivers, n, tp.edge_capacity)
    for f in ("u_local", "v_local", "block_window", "edge_perm", "valid", "spill"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.window, a.block, a.spill_count) == (b.window, b.block, b.spill_count)
    assert (b.spill_count > 0) == spill and b.spill.shape == (8192,)
    assert not b.spill[b.spill_count:].any() and b.k_blocks == 0
    nw = -(-n // 128)
    assert set(b.block_window) == set(range(nw)) and (np.diff(b.block_window) >= 0).all()
    assert b.num_blocks == tblk.blocks_capacity(tp.edge_capacity, n, 128, 128)
    # Within a window's run of blocks the lanes ascend by destination row,
    # pad lanes (the sentinel) last: what the kernel's row search relies on.
    lane_w = np.repeat(b.block_window, 128)
    for w in range(nw):
        assert (np.diff(b.v_local[lane_w == w]) >= 0).all()


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("spill", [False, True], ids=["fits", "spill"])
def test_local_batch_equals_jax(name, spill):
    """``as_batch(blocked="local")`` equals the JAX package's key by key for
    every model, from ``as_batches_uniform`` too (which in the JAX package
    re-runs ``as_batch`` with the tail's capacity pinned: the same batches);
    ``window``, ``block`` and ``spill_capacity`` are ignored."""
    jp, tp = _packed(name, spill)
    batch = _batches(name, spill)["local"]
    assert {"loc_ulocal", "loc_vlocal", "loc_window", "in_deg", "out_deg"} <= set(batch)
    assert "loc_ell" not in batch and "pool_gl" not in batch
    for a, b in zip(jb.as_batches_uniform([jp, jp], blocked="local"),
                    tb.as_batches_uniform([tp, tp], blocked="local")):
        _assert_batches_equal(a, b)
    _assert_batches_equal(jb.as_batch(jp, blocked="local", window=256, spill_capacity=1024),
                          tb.as_batch(tp, blocked="local", window=256, spill_capacity=1024))


def test_local_batch_raises_past_its_fixed_tail():
    """More than 8192 crossing edges raise ``ValueError`` in both packages: a
    4500-node chain in random order crosses a window on nearly every edge."""
    graph = lambda mod: [mod.random_molecule_graph(np.random.default_rng(7), num_nodes=4500)]
    kw = dict(node_capacity=8191, edge_capacity=16384, graph_capacity=4, window=128)
    jp, tp = jg.pack_graphs_aligned(graph(js), **kw), tg.pack_graphs_aligned(graph(ts), **kw)
    crossing = int((tp.senders // 128 != tp.receivers // 128).sum())
    assert crossing > 8192
    for fn, packed in ((jb.as_batch, jp), (tb.as_batch, tp)):
        with pytest.raises(ValueError, match=f"spill capacity 8192 < {crossing}"):
            fn(packed, blocked="local")
    with pytest.raises(ValueError, match="crossing edges"):
        tb.as_batches_uniform([tp], blocked="local")


@pytest.mark.parametrize("geometry,final", [("W128", False), ("W128", True), ("spill", False)],
                         ids=["layer", "final", "spill"])
def test_gin_local_layer_ref_matches_jax(geometry, final, monkeypatch):
    """Row 10's plain version (nonzero ``m_spill``) against the Pallas
    ``gin_local_layer`` in interpret mode, a layer and the last layer, and
    on a bucket with a 300-node graph, f32 to 1e-5."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gin_blocks_operands("gin_local_layer", geometry, final)
    got = local_layer.gin_local_layer(**_port(ops, "cpu"))
    want = _jax_kernel("gin_local_layer", ops)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 1e-2
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("geometry", ["W128", "k2"])
def test_gin_local_layer_ell_lanes_ref_matches_jax(geometry, monkeypatch):
    """Row 12's plain version against the Pallas ``gin_local_layer_ell``
    without ``edge_attr`` (``local_scatter_apply_ell``) in interpret mode at
    k=1 and k=2, f32 to 1e-5, through ``gin_local_layer_ell(ee=...)``; and,
    with the embeddings summed from the table, against row 13's plain
    version (summation order of three table rows: 1e-6)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gin_blocks_operands("gin_local_layer_ell_lanes", geometry, final=geometry == "k2")
    t = _port(ops, "cpu")
    got = local_layer.gin_local_layer_ell(**{k: v for k, v in t.items() if k != "ee"},
                                          ee_table=None, ee=t["ee"])
    torch.testing.assert_close(got, local_layer.gin_local_layer_ell_lanes(**t), rtol=0, atol=0)
    meta = ops["ell_meta"]
    jax_ops = {k: v for k, v in ops.items() if k != "ell_meta"}
    want = _jax_kernel("gin_local_layer_ell", dict(
        jax_ops, u_local=meta[:, 0].copy(), v_local=meta[:, 1].copy(),
        k_blocks=ELL_LAYER_GEOMETRY[geometry][2]))
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    _close(got.numpy(), want, 1e-5)

    table = torch.randn(13, t["ee"].shape[1], generator=torch.Generator().manual_seed(0)) * 0.2
    rows = t["ell_meta"][:, 2:].long().clamp(0, 12)
    rest = {k: v for k, v in t.items() if k != "ee"}
    summed = local_layer.gin_local_layer_ell_lanes(**rest, ee=table[rows].sum(1))
    _close(summed.numpy(), local_layer.gin_local_layer_ell(**rest, ee_table=table).numpy(), 1e-6)


def test_gin_local_layer_ell_needs_a_table_or_lane_embeddings():
    """``gin_local_layer_ell`` takes the layer's table or each lane's
    embedding; with neither it raises before any dispatch."""
    t = _port(_gin_blocks_operands("gin_local_layer_ell_lanes", "W128", final=False), "cpu")
    with pytest.raises(ValueError, match="neither"):
        local_layer.gin_local_layer_ell(**{k: v for k, v in t.items() if k != "ee"},
                                        ee_table=None)


def _kw(name: str) -> dict:
    return dict(fpga_eps=name == "gin") if name.startswith("gin") else {}


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("spill", [False, True], ids=["fits", "spill"])
def test_local_forward_matches_jax_and_plain(name, spill, monkeypatch):
    """On a legacy local batch GIN and GIN-VN run row 10 per layer (GIN-VN
    with the trained ε, its VN messages folded into ``m_spill``) and GCN,
    PNA, DGN and GAT their plain loop, as the JAX package does: f32 1e-5
    against the JAX forward with every intermediate, f64 against the port's
    plain path on the rows of real nodes (1e-9; DGN 1e-6)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    b = _batches(name, spill)
    params = SMALL[name.split("-")[0]]()
    fwd = tr.get(name).forward
    p32 = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    out, inter = fwd(p32, b["local"], tn.FLOAT32, return_intermediates=True, **_kw(name))
    want, layers, h_graph = _jax_forward(name, params, b["jax"], **_kw(name))
    assert out.shape == want.shape and np.ptp(want[:G]) > 1e-4 and np.isfinite(want).all()
    _close(out[:G].numpy(), want[:G], 1e-5)
    assert len(inter["layers"]) == len(layers)
    for got_l, want_l in zip(inter["layers"], layers):
        _close(got_l.numpy(), want_l, 1e-5)
    _close(inter["h_graph"][:G].numpy(), h_graph[:G], 1e-5)
    np.testing.assert_array_equal(fwd(p32, b["local"], tn.FLOAT32, **_kw(name)).numpy(),
                                  out.numpy())

    tol = 1e-6 if name == "dgn" else 1e-9
    p64 = loaders.params_from_numpy(params, tn.FLOAT64, "cpu")
    out, inter = fwd(p64, b["local"], tn.FLOAT64, return_intermediates=True, **_kw(name))
    want, want_inter = fwd(p64, b["plain"], tn.FLOAT64, return_intermediates=True, **_kw(name))
    real = b["plain"]["node_graph"] < G
    np.testing.assert_allclose(out[:G].numpy(), want[:G].numpy(), rtol=tol, atol=tol)
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        np.testing.assert_allclose(got_l[real].numpy(), want_l[real].numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", MODELS)
def test_local_dispatch_runs_the_jax_rows(name, monkeypatch):
    """On a legacy local batch GIN and GIN-VN call ``gin_local_layer`` once
    per layer and no other kernel; the other models call none at all (their
    JAX dispatch tests for ``loc_ell`` or the slot keys)."""
    from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna
    from flowgnn_tpu_torch.ops import spmm

    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    counted(spmm, "windowed_segment_sum")
    for mod in (dgn, gat, gcn, gin, pna):
        for k in dir(mod):
            if k.startswith(("gin_l", "gcn_l", "pna_l", "dgn_l", "gat_l")):
                counted(mod, k)
    b = _batches(name, spill=True)
    p = loaders.params_from_numpy(SMALL[name.split("-")[0]](), tn.FLOAT32, "cpu")
    tr.get(name).forward(p, b["local"], tn.FLOAT32, **_kw(name))
    assert calls == ({"gin_local_layer": 2} if name.startswith("gin") else {})


def test_local_spill_tail_is_live():
    """Dead-wiring guard: routing the spill tail's lanes to the pad node
    changes GIN's output on a batch whose large graph crosses windows."""
    b = _batches("gin", spill=True)["local"]
    p = loaders.params_from_numpy(SMALL["gin"](), tn.FLOAT32, "cpu")
    good = tr.get("gin").forward(p, b, tn.FLOAT32)
    recv = b["receivers"].clone()
    recv[b["loc_ulocal"].shape[0]:] = b["node_feat"].shape[0] - 1
    bad = tr.get("gin").forward(p, dict(b, receivers=recv), tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("prec", [tn.FLOAT32, tn.BF16], ids=["f32", "bf16"])
def test_local_operands_meet_the_kernel_contract(name, prec):
    """What the legacy local path hands row 10 is what the CUDA wrapper
    accepts: contiguous tensors, int32 lanes, values in the compute dtype,
    float32 ``eps1``."""
    from flowgnn_tpu_torch.models import gin

    batch = _batches(name, spill=True)["local"]
    params = loaders.params_from_numpy(SMALL["gin"](), prec, "cpu")
    kernels = gin.layer_kernel_operands(params, batch, prec)
    assert set(kernels) == {"gin_local_layer"}
    ops = kernels["gin_local_layer"]
    p, n = batch["loc_ulocal"].shape[0], batch["node_feat"].shape[0]
    for k, v in ops.items():
        if torch.is_tensor(v):
            assert v.is_contiguous(), k
            ints = k in ("u_local", "v_local", "block_window")
            assert v.dtype == (torch.int32 if ints else torch.float32 if k == "eps1"
                               else prec.compute_dtype), k
    assert ops["ee"].shape == (p, 32) and ops["h"].shape == ops["m_spill"].shape == (n, 32)
    assert ops["block_window"].shape[0] * 128 == p and ops["window"] == 128


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("spill", [False, True], ids=["fits", "spill"])
def test_ell_layer_loop_with_lane_embeddings_matches_the_table_path(name, spill):
    """``gin.ell_layer_operands(lane_ee=True)`` feeds ``gin_local_layer_ell``
    each ELL lane's bond embedding and no table (row 12's entry): layer by
    layer it reproduces the intermediates of the forward whose layers sum
    the table rows inside row 13 (f32: three table rows in another order,
    1e-6), on an ELL batch with and without a spill tail."""
    from flowgnn_tpu_torch.models import gin

    _, tp = _packed(name, spill)
    batch = tb.to_device(tb.as_batch(tp, blocked="local_ell", window=128, block=512), "cpu")
    assert bool(tb.ell_spill_lanes(batch)) == spill
    p = loaders.params_from_numpy(SMALL["gin"](), tn.FLOAT32, "cpu")
    _, want = gin.forward(p, batch, tn.FLOAT32, return_intermediates=True, **_kw(name))
    eps_all = gin.eps1_all(p, tn.FLOAT32, **_kw(name))
    meta, tail = tb.ell_meta(batch), tb.ell_spill(batch)
    h = tb.atom_embed(p["node_embedding"], batch["node_feat"], tn.FLOAT32)
    for l, want_l in enumerate(want["layers"][1:]):
        ops = gin.ell_layer_operands(p, batch, tn.FLOAT32, l, h, meta, tail, eps_all,
                                     lane_ee=True)
        assert ops["ee_table"] is None and ops["ee"].shape == (meta.shape[0], h.shape[1])
        h = local_layer.gin_local_layer_ell(**ops)
        _close(h.numpy(), want_l.numpy(), 1e-6)
