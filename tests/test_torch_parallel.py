"""The port's sharded paths (``flowgnn_tpu_torch.parallel``) against the JAX
package's ``flowgnn_tpu.parallel``, on the CPU: the halo layouts of
``build_halo_batch`` key by key (``blocked=None`` / ``"local_ell"`` /
``"local_slots"`` at k = 2, 4 and 8, on a window-aligned packing and on one
whose graphs straddle windows and shards; the JAX side through its numpy ELL
layout routine, the port's through its native one), the capacity errors,
``halo_batches_uniform``; the axis variants of the four segment ops over 8
ranks against JAX's under an 8-device ``shard_map``; the kernels each halo
case calls per rank (monkeypatched counters); and row 31's operands on a
spilling halo shard holding none of the exchanged rows.

The ranks run as threads of the test process (``parallel.mesh.run_threads``:
gloo process groups over one ``HashStore``)."""

import dataclasses
import threading
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.ops import segment as jseg
from flowgnn_tpu.parallel import halo as jhalo
from flowgnn_tpu.parallel.mesh import make_mesh as jax_mesh
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import segment as tseg
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.parallel import halo, inference
from flowgnn_tpu_torch.parallel import mesh as pm

LAYOUT_CAPS = dict(node_capacity=4095, edge_capacity=12288, graph_capacity=192)
WINDOW = 512  # the halo local layouts' window (models.base.ELL_DEFAULT_GEOMETRY)
SMALL = {
    "gin": lambda: loaders.synthetic_gin_params(4, dim=16, hidden=32, layers=2),
    "gcn": lambda: loaders.synthetic_gcn_params(4, dim=16, layers=2),
    "pna": lambda: loaders.synthetic_pna_params(4, dim=16, layers=2),
    "dgn": lambda: loaders.synthetic_dgn_params(4, dim=16, layers=2),
    "gat": lambda: loaders.synthetic_gat_params(4, dim=16, heads=2, layers=3),
}


def packing(name: str, aligned: bool, count: int = 130, seed: int = 5, caps=None):
    """The port's packing of ``count`` transformed molhiv-shaped graphs and
    the same packing as the JAX package's ``PackedGraphs``."""
    spec = tr.get(name)
    gs = tr.apply_transforms(spec, ts.synthetic_molhiv(count, seed=seed))
    caps = dict(caps or LAYOUT_CAPS, with_eigen=spec.needs_eigen)
    packed = (tg.pack_graphs_aligned(gs, window=WINDOW, **caps) if aligned
              else tg.pack_graphs(gs, **caps))
    return packed, jg.PackedGraphs(**dataclasses.asdict(packed))


def assert_layouts_equal(jb: dict, tb: dict) -> None:
    """Same keys, shapes and values; the same dtypes except where the JAX
    package stores exact small integers as floats (its bfloat16
    ``pool_gl``, its bfloat16 / float32 ``slot_stack``), which the port
    stores as int32."""
    assert set(jb) == set(tb)
    for k in jb:
        a, b = np.asarray(jb[k]), np.asarray(tb[k])
        assert a.shape == b.shape, k
        if k == "slot_stack" or a.dtype.name == "bfloat16":
            assert b.dtype == np.int32, (k, b.dtype)
        else:
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), k


@pytest.mark.parametrize("blocked", [None, "local_ell", "local_slots"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "straddling"])
def test_halo_layout_matches_jax(blocked, k, aligned, monkeypatch):
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")  # the JAX side's numpy ELL layout
    packed, jpacked = packing("gin", aligned)
    kw = dict(k=k, edge_slack=float(k), blocked=blocked)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jhalo.build_halo_batch(jpacked, **kw)
        got = halo.build_halo_batch(packed, **kw)
    assert_layouts_equal(want, got)
    s = got["node_feat"].shape[1]
    assert (got["receivers"] <= s).all() and got["halo_send_idx"].shape == (k, k, 256)
    if blocked is not None:
        lanes = got["loc_ulocal"].shape[-1] if blocked == "local_ell" else 0
        spill = (got["senders"].shape[-1] - lanes if blocked == "local_ell"
                 else got["slot_spill"].shape[-1])
        # Straddling graphs cross windows and shards: the tail holds them.
        assert (spill > 0) == (not aligned)
        assert ("pool_gl" in got) == aligned
    if not aligned:
        assert got["halo_send_idx"].any()  # boundary rows to exchange


def test_halo_layout_multiwindow_shards(monkeypatch):
    """k=2 over 4096 rows: shards of four 512-row windows, whose lanes the
    trash window's trim must leave in kernel order; DGN's eigenvectors and
    GIN-VN's flags shard with the rows."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    for name in ("dgn", "gin-vn"):
        packed, jpacked = packing(name, False)
        for blocked in ("local_ell", "local_slots"):
            want = jhalo.build_halo_batch(jpacked, k=2, edge_slack=2.0, blocked=blocked)
            got = halo.build_halo_batch(packed, k=2, edge_slack=2.0, blocked=blocked)
            assert got["node_feat"].shape[1] == 4 * WINDOW
            assert_layouts_equal(want, got)


def test_halo_capacity_errors():
    packed, jpacked = packing("gin", False)
    for fn, p in ((jhalo.build_halo_batch, jpacked), (halo.build_halo_batch, packed)):
        with pytest.raises(ValueError, match="edge capacity/chip"):
            fn(p, k=4, edge_slack=0.5)
        with pytest.raises(ValueError, match="halo capacity"):
            fn(p, k=4, edge_slack=4.0, halo_cap=2)
    assert dataclasses.asdict(halo.halo_shape(4095, 12288, 4, window=512)) == \
        dataclasses.asdict(jhalo.halo_shape(4095, 12288, 4, window=512))
    shape = halo.halo_shape(4095, 12288, 4)
    assert halo.halo_bytes_per_layer(shape, 100) == jhalo.halo_bytes_per_layer(
        jhalo.halo_shape(4095, 12288, 4), 100) == 4 * 256 * 100 * 4
    assert halo.psum_bytes_per_layer(4095, 80) == jhalo.psum_bytes_per_layer(4095, 80)


def _stream(name: str, mixed: bool = False):
    """Three buckets of one stream whose graphs straddle windows and whose
    content differs (the last holds a 250-node graph: deeper slots, a longer
    spill tail); ``mixed`` swaps the last for a bucket small enough that all
    its graphs sit in one window, so it alone has the pooling layout."""
    spec = tr.get(name)
    rng = np.random.default_rng(9)
    gs = tr.apply_transforms(spec, ts.synthetic_molhiv(130, seed=6))
    big = tr.apply_transforms(spec, [ts.random_molecule_graph(rng, num_nodes=250)])
    caps = dict(node_capacity=2047, edge_capacity=8192, graph_capacity=64,
                with_eigen=spec.needs_eigen)
    last = gs[:8] if mixed else gs[:20] + big
    buckets = [tg.pack_graphs(gs[:60], **caps), tg.pack_graphs(gs[60:120], **caps),
               tg.pack_graphs(last, **caps)]
    return buckets, [jg.PackedGraphs(**dataclasses.asdict(b)) for b in buckets]


@pytest.mark.parametrize("blocked", [None, "local_ell", "local_slots"])
def test_halo_batches_uniform_matches_jax(blocked, monkeypatch):
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    buckets, jbuckets = _stream("gin")
    want = jhalo.halo_batches_uniform(jbuckets, k=2, blocked=blocked, edge_slack=2.0)
    got = halo.halo_batches_uniform(buckets, k=2, blocked=blocked, edge_slack=2.0)
    assert len({tuple(sorted((k, v.shape) for k, v in hb.items())) for hb in got}) == 1
    for w, g in zip(want, got):
        assert_layouts_equal(w, g)
    inference.stack_halo_buckets(got)  # one signature: they stack
    if blocked is not None:  # the first build differed: the pins did the work
        first = [halo.build_halo_batch(b, k=2, blocked=blocked, edge_slack=2.0) for b in buckets]
        assert len({tuple(sorted((k, v.shape) for k, v in hb.items())) for hb in first}) > 1


@pytest.mark.parametrize("blocked", ["local_ell", "local_slots"])
def test_halo_batches_uniform_raises_without_one_signature(blocked, monkeypatch):
    """Reference fault (``flowgnn_tpu/parallel/halo.py:71-88``): on a stream
    where one bucket's graphs all sit in one window and the others' do not,
    only that bucket has the pooling layout, no pin reconciles it, and the
    JAX package returns batches of two signatures, which no data axis can
    stack. The port raises instead."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    buckets, jbuckets = _stream("gin", mixed=True)
    want = jhalo.halo_batches_uniform(jbuckets, k=2, blocked=blocked, edge_slack=2.0)
    assert len({tuple(sorted(hb)) for hb in want}) == 2
    with pytest.raises(ValueError, match="layout signatures"):
        halo.halo_batches_uniform(buckets, k=2, blocked=blocked, edge_slack=2.0)


def _jax_segments(data, ids, n, k, init):
    mesh = jax_mesh(data=1, edge=k)
    fns = {
        "sum": lambda d, s: jseg.segment_sum(d, s, n, axis_name="edge"),
        "mean": lambda d, s: jseg.segment_mean(d, s, n, axis_name="edge"),
        "min": lambda d, s: jseg.segment_min(d, s, n, init, axis_name="edge"),
        "max": lambda d, s: jseg.segment_max(d, s, n, -init, axis_name="edge"),
    }
    return {name: np.asarray(jax.shard_map(fn, mesh=mesh, in_specs=(P("edge"), P("edge")),
                                           out_specs=P(), check_vma=False)(data, ids))
            for name, fn in fns.items()}


def _port_segments(rank, store, data, ids, n, k, init, dtype):
    mesh = pm.make_mesh(1, k, rank=rank, store=store, log=False)
    per = data.shape[0] // k
    d = torch.from_numpy(data[rank * per : (rank + 1) * per]).to(dtype)
    s = torch.from_numpy(ids[rank * per : (rank + 1) * per])
    ax = mesh.edge
    return {"sum": tseg.segment_sum(d, s, n, ax), "mean": tseg.segment_mean(d, s, n, ax),
            "min": tseg.segment_min(d, s, n, init, ax),
            "max": tseg.segment_max(d, s, n, -init, ax)}


def test_segment_axis_variants_match_jax():
    """Each rank reduces its 1/8 of the edges, one all-reduce completes them:
    f32 against the JAX psum / pmin / pmax (an empty segment keeps the seed),
    and in bf16 the sum is the f32 sum of all ranks rounded once."""
    k, n, e, init = 8, 37, 8 * 64, 7.5
    rng = np.random.default_rng(0)
    data = rng.normal(size=(e, 5)).astype(np.float32) * 4
    ids = rng.integers(0, n - 3, size=e).astype(np.int32)  # the last 3 segments empty
    want = _jax_segments(data, ids, n, k, init)
    got = pm.run_threads(_port_segments, k, data, ids, n, k, init, torch.float32)
    for rank_out in got:
        for name, w in want.items():
            np.testing.assert_allclose(rank_out[name].numpy(), w, rtol=1e-6, atol=1e-5,
                                       err_msg=name)
    assert (got[0]["min"][-3:] == init).all() and (got[0]["max"][-3:] == -init).all()
    bf = pm.run_threads(_port_segments, k, data, ids, n, k, init, torch.bfloat16)
    d16 = torch.from_numpy(data).to(torch.bfloat16).float()
    once = torch.zeros(n, 5).index_add_(0, torch.from_numpy(ids).long(), d16).to(torch.bfloat16)
    for rank_out in bf:
        assert rank_out["sum"].dtype == torch.bfloat16
        torch.testing.assert_close(rank_out["sum"], once, rtol=0, atol=0)


# Per-rank kernel calls of each halo case (L layers): the JAX package's gates
# (flowgnn_tpu/models/*.py), rows 1, 2, 24 and 25 never under an axis.
KERNELS = {
    "gin": ("gin_local_model", "gin_local_layer_ell", "gin_local_message_ell",
            "gin_local_model_slots", "gin_layer_fused", "gin_local_layer"),
    "gcn": ("gcn_local_model", "gcn_local_layer_ell", "gcn_local_message_ell",
            "gcn_local_model_slots"),
    "pna": ("pna_local_model", "pna_local_layer", "pna_local_stats_ell"),
    "dgn": ("dgn_local_model", "dgn_local_layer_slots", "dgn_local_layer_ell",
            "dgn_local_message_ell"),
    "gat": ("gat_local_model_slots", "gat_local_message_slots", "gat_local_message_ell",
            "gat_local_layer_ell"),
}


def expected_calls(name: str, case: str, layers: int, inter: bool) -> dict:
    model = name.split("-")[0]
    table = {
        "plain": {},
        "slots": {"pna": {"pna_local_model": 1}, "dgn": {"dgn_local_model": 1},
                  "gat": {"gat_local_model_slots": 1}},
        "slots_inter": {"pna": {"pna_local_layer": layers},
                        "dgn": {"dgn_local_layer_slots": layers},
                        "gat": {"gat_local_message_slots": layers}},
        "slots_spill": {"pna": {"pna_local_stats_ell": layers}},
        "ell": {"gin": {"gin_local_model": 1}, "gcn": {"gcn_local_model": 1},
                "dgn": {"dgn_local_layer_ell": layers},
                "gat": {"gat_local_message_ell": layers}},
        "ell_inter": {"gin": {"gin_local_layer_ell": layers},
                      "gcn": {"gcn_local_layer_ell": layers},
                      "dgn": {"dgn_local_layer_ell": layers},
                      "gat": {"gat_local_message_ell": layers}},
        "ell_spill": {"gin": {"gin_local_message_ell": layers},
                      "gcn": {"gcn_local_message_ell": layers},
                      "dgn": {"dgn_local_message_ell": layers},
                      "gat": {"gat_local_message_ell": layers}},
    }
    key = case + ("_inter" if inter and case in ("slots", "ell") else "")
    return table[key].get(model, {})


CASES = {  # case → (blocked, aligned)
    "plain": (None, False), "slots": ("local_slots", True), "slots_spill": ("local_slots", False),
    "ell": ("local_ell", True), "ell_spill": ("local_ell", False),
}


def _counted_rank(rank, store, name, k, stacked, params_np, inter):
    from flowgnn_tpu_torch.models.base import to_device

    mesh = pm.make_mesh(1, k, rank=rank, store=store, log=False)
    params = loaders.params_from_numpy(params_np, tn.FLOAT32, "cpu")
    local = to_device(inference.halo_shard_slice(stacked, mesh), "cpu")
    return tr.get(name).forward(params, local, tn.FLOAT32, return_intermediates=inter,
                                edge_axis=mesh.edge)


def count_halo_calls(name: str, case: str, k: int, inter: bool, monkeypatch):
    """{wrapper: calls per rank} of the halo forward of ``case`` at k ranks."""
    import importlib

    blocked, aligned = CASES[case]
    packed, _ = packing(name, aligned, count=30, caps=dict(
        node_capacity=1023, edge_capacity=4096, graph_capacity=48))
    stacked = inference.stack_halo_buckets([halo.build_halo_batch(
        packed, k=k, edge_slack=2.0 * k, blocked=blocked)])
    model = name.split("-")[0]
    mod = importlib.import_module(f"flowgnn_tpu_torch.models.{model}")
    calls: dict = {}
    lock = threading.Lock()
    from flowgnn_tpu_torch.models import base as tbase

    def counted(owner, fn_name):
        fn = getattr(owner, fn_name)

        def wrapper(*args, **kw):
            with lock:
                calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(owner, fn_name, wrapper)

    for fn_name in KERNELS[model]:
        counted(mod, fn_name)
    counted(tbase, "windowed_segment_sum")
    params_np = SMALL[model]()
    pm.run_threads(_counted_rank, k, name, k, stacked, params_np, inter)
    assert all(v % k == 0 for v in calls.values()), calls
    return {kname: v // k for kname, v in calls.items()}, stacked


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn", "pna", "dgn", "gat"])
@pytest.mark.parametrize("case", list(CASES))
def test_halo_cases_call_the_jax_rows(name, case, monkeypatch):
    """Per rank, each halo case calls the kernels the JAX package's gates
    pick (the kernel table's halo column): rows 8 and 31 for GIN, 9 and 14
    for GCN, 3 / 20 / 19 for PNA, 4 / 22 / 18 / 16 for DGN, 5 / 21 / 17 for
    GAT, nothing on the plain halo layout, and rows 1, 2 and 24 never."""
    layers = {"gat": 3}.get(name, 2)
    for inter in ((False, True) if case in ("slots", "ell") else (False,)):
        got, stacked = count_halo_calls(name, case, 2, inter, monkeypatch)
        spill = (stacked["slot_spill"].shape[-1] if "slot_spill" in stacked
                 else stacked["senders"].shape[-1] - stacked["loc_ulocal"].shape[-1]
                 if "loc_ulocal" in stacked else 0)
        if case == "ell" and name == "gat":
            assert spill > 0  # GAT's self loops overflow a window's lanes: row 17 with a tail
        elif case in ("slots", "ell"):
            assert spill == 0
        elif case != "plain":
            assert spill > 0
        assert got == expected_calls(name, case, layers, inter), (name, case, inter, got)


def _row31_rank(rank, store, stacked, params_np, seen):
    from flowgnn_tpu_torch.models import base as tbase

    mesh = pm.make_mesh(1, 2, rank=rank, store=store, log=False)
    params = loaders.params_from_numpy(params_np, tn.FLOAT32, "cpu")
    batch = tbase.to_device(inference.halo_shard_slice(stacked, mesh), "cpu")
    return tr.get("gin").forward(params, batch, tn.FLOAT32, edge_axis=mesh.edge)


def test_halo_row31_reads_no_exchanged_row(monkeypatch):
    """On a spilling halo shard each layer issues the boundary-row exchange
    before row 31 and hands row 31 the rank's own S rows only, never the
    extended [S + k·H] array: the kernel has no data edge into the exchange
    (``flowgnn_tpu/models/gin.py:199-207``; the JAX package's
    ``test_halo_overlap_independence``)."""
    packed, _ = packing("gin", False, count=30, caps=dict(
        node_capacity=1023, edge_capacity=4096, graph_capacity=48))
    stacked = inference.stack_halo_buckets([halo.build_halo_batch(
        packed, k=2, edge_slack=4.0, blocked="local_ell")])
    assert stacked["senders"].shape[-1] > stacked["loc_ulocal"].shape[-1]  # it spills
    from flowgnn_tpu_torch.models import base as tbase
    from flowgnn_tpu_torch.models import gin

    events: list = []
    real_exchange, real_row31 = tbase.halo_exchange, gin.gin_local_message_ell

    def exchange(h, batch, axis, wait=True):
        done = real_exchange(h, batch, axis, wait=wait)
        events.append((threading.current_thread().name, "exchange", wait, h.shape[0]))
        return done

    def row31(**ops):
        events.append((threading.current_thread().name, "row31", None, ops["h"].shape[0]))
        return real_row31(**ops)

    monkeypatch.setattr(tbase, "halo_exchange", exchange)
    monkeypatch.setattr(gin, "gin_local_message_ell", row31)
    pm.run_threads(_row31_rank, 2, stacked, SMALL["gin"](), events)
    s_rows = stacked["node_feat"].shape[2]
    for thread in {e[0] for e in events}:
        mine = [e[1:] for e in events if e[0] == thread]
        # Per layer: the exchange issued (not waited on), then row 31 on
        # the rank's own S rows, not on S + k·H.
        assert mine == [("exchange", False, s_rows), ("row31", None, s_rows)] * 2, mine
