"""The port's streaming runtime (``flowgnn_tpu_torch.runtime.stream``) and
its sustained host application (``bench.host_app``) on the CPU, against
the JAX package's ``InferenceStream`` (Pallas kernels in interpret mode):
every model's predictions over a few buckets with a weight flip, f32 at
1e-5; interleaved weight sets, order at ``graph_capacity=2``, an unknown
set, ``run_pipelined`` against ``run``; the slot pins merged from eight
threads; the int8 transfer (exact where the features fit, raising where
not); the pinned input buffer's layout; ``host_app.main`` on the CPU.
Small widths: D=16, H=32, L=2 (GAT 2 heads × 16)."""

import contextlib
import io
import itertools
import json
import threading

import numpy as np
import pytest
import torch

from flowgnn_tpu.core.numerics import FLOAT32 as JAX_FLOAT32
from flowgnn_tpu.runtime.stream import InferenceStream as JaxStream
from flowgnn_tpu_torch.bench import host_app
from flowgnn_tpu_torch.core.graphs import pack_graphs, pack_graphs_aligned
from flowgnn_tpu_torch.core.numerics import FLOAT32
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_molhiv
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.runtime import stream as rs

MODELS = ("gin", "gin-vn", "gcn", "gat", "pna", "dgn")
CAPS = dict(node_capacity=255, edge_capacity=1024, graph_capacity=4)


def small_params(name: str, seed: int) -> dict:
    kind = name.split("-")[0]
    kw = dict(dim=16, layers=2)
    if kind == "gin":
        kw["hidden"] = 32
    if kind == "gat":
        kw["heads"] = 2
    return getattr(loaders, f"synthetic_{kind}_params")(seed, **kw)


def cpu_stream(name: str, sets: int = 2, **caps) -> rs.InferenceStream:
    return rs.InferenceStream(name, [small_params(name, s) for s in range(sets)], FLOAT32,
                              device="cpu", **{**CAPS, **caps})


@pytest.fixture(scope="module")
def graphs():
    return synthetic_molhiv(12, seed=3)


@pytest.mark.parametrize("name", MODELS)
def test_stream_matches_jax_stream(name, graphs, monkeypatch):
    """Twelve molhiv-shaped graphs, weight set 0 for the first six and 1
    for the rest, buckets of at most 4 graphs and 255 node rows (GIN-VN and
    GAT bucket at their own windows, 128 here, 256 and 384 in the JAX
    package): the same prediction per graph, f32 to 1e-5 of the largest."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    sets = [small_params(name, 0), small_params(name, 1)]
    items = [(g, int(i >= 6)) for i, g in enumerate(graphs)]
    got = np.array(list(rs.InferenceStream(name, sets, FLOAT32, device="cpu", **CAPS).run(items)))
    want = np.array(list(JaxStream(name, sets, JAX_FLOAT32, **CAPS).run(items)), np.float64)
    assert got.shape == want.shape == (12,) and np.ptp(want) > 1e-3
    scale = max(1e-2, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5)


def test_interleaved_weight_sets_equal_each_set_alone(graphs):
    """Sets A A B B A B A A: each set's graphs give what that set gives on
    them alone (buckets close at every flip), and the sets differ."""
    stream = cpu_stream("gin", node_capacity=511, edge_capacity=2048, graph_capacity=8)
    sets = [0, 0, 1, 1, 0, 1, 0, 0]
    items = list(zip(graphs[:8], sets))
    got = np.array(list(stream.run(items)))
    assert stream.last_dispatches == 5 and len(stream.last_buckets) == 5
    mask = np.array(sets)
    for s in (0, 1):
        alone = np.array(list(stream.run([(g, s) for g, sid in items if sid == s])))
        np.testing.assert_allclose(got[mask == s], alone, rtol=1e-6, atol=1e-6)
    every = [np.array(list(stream.run([(g, s) for g in graphs[:8]]))) for s in (0, 1)]
    assert np.abs(every[0] - every[1]).min() > 1e-4


def test_order_preserved_at_two_graphs_a_bucket(graphs):
    small = cpu_stream("gat", graph_capacity=2)
    items = [(g, 0) for g in graphs[:7]]
    got = np.array(list(small.run(items)))
    assert small.last_dispatches == 4
    want = np.array(list(cpu_stream("gat", graph_capacity=16).run(items)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unknown_weight_set_raises(graphs):
    stream = cpu_stream("gin")
    for bad in (2, 7, -1):
        with pytest.raises(ValueError, match="unknown weight set"):
            list(stream.run([(graphs[0], 0), (graphs[1], bad)]))


@pytest.mark.parametrize("name", ["gin", "dgn"])
def test_run_pipelined_equals_run(name, graphs):
    """Across flips and bucket boundaries, with chains and workers."""
    stream = cpu_stream(name, graph_capacity=2)
    items = [(g, (i // 5) % 2) for i, g in enumerate(graphs)]
    seq = np.array(list(stream.run(items)))
    for depth, chain, workers in ((1, 1, 1), (2, 3, 3), (3, 4, 8)):
        pipe = np.array(list(stream.run_pipelined(items, depth=depth, chain=chain,
                                                  workers=workers)))
        np.testing.assert_allclose(pipe, seq, rtol=1e-6, atol=1e-6)
        assert len(stream.last_buckets) == 7 and stream.last_dispatches <= 7


def test_pins_from_eight_threads_equal_sequential_maxima():
    """Eight threads derive slot pins concurrently over 16 buckets: the
    pins end as the sequential run's, each the maximum over the buckets'
    own layouts (the JAX stream's unlocked read-merge-write could lose a
    thread's pins)."""
    gs = synthetic_molhiv(64, seed=11)
    stream = cpu_stream("gin", sets=1)
    buckets = [b for b, _ in stream._bucketize((g, 0) for g in gs)]
    assert len(buckets) == 16
    seq = cpu_stream("gin", sets=1)
    for b in buckets:
        seq._make_batch(b)
    natural = []
    for b in buckets:
        window, block = base.choose_geometry("gin", max(g.num_nodes for g in b))
        packed = pack_graphs_aligned(b, CAPS["node_capacity"], CAPS["edge_capacity"],
                                     CAPS["graph_capacity"], window=window)
        batch = base.as_batch(packed, blocked="local_slots", window=window, block=block)
        s = batch["slot_geom"].shape[-1]
        natural.append((s, base.slot_prefix_caps(batch, s)))
    maxima = {"slots": max(s for s, _ in natural), "prefix_caps": tuple(
        max(c) for c in itertools.zip_longest(*(c for _, c in natural), fillvalue=64))}
    assert seq._pins == {128: maxima}
    assert len({c for _, c in natural}) > 1  # the buckets need different caps
    for trial in range(3):
        threaded = cpu_stream("gin", sets=1)
        barrier = threading.Barrier(8)

        def work(i):
            barrier.wait()
            for b in buckets[i::8] + buckets[(i + trial) % 8::8]:
                threaded._make_batch(b)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert threaded._pins == seq._pins


@pytest.mark.parametrize("name", MODELS)
def test_int8_features_exact_and_range_checked(name, graphs):
    """The int8 transfer of ``node_feat`` and ``edge_attr`` changes no
    prediction (the models widen them against int offsets); a feature that
    does not fit int8 raises instead of wrapping."""
    stream = cpu_stream(name, sets=1)
    bucket = registry.apply_transforms(stream.spec, graphs[:4])
    batch, n = stream._make_batch(bucket)
    assert batch["node_feat"].dtype == batch["edge_attr"].dtype == np.int8
    wide = dict(batch, node_feat=batch["node_feat"].astype(np.int32),
                edge_attr=batch["edge_attr"].astype(np.int32))
    forward = lambda b: stream.spec.forward(stream.params[0], base.to_device(b, "cpu"), FLOAT32)
    assert torch.equal(forward(batch)[:n], forward(wide)[:n])
    for key, value in (("node_feat", 200), ("node_feat", -129), ("edge_attr", 128)):
        g = bucket[0]
        arr = getattr(g, key).copy()
        arr[0, 0] = value
        bad = [type(g)(**{**g.__dict__, key: arr})] + bucket[1:]
        with pytest.raises(ValueError, match="int8"):
            stream._make_batch(bad)


def test_input_buffer_round_trips_the_batch():
    """``pack_inputs`` lays a batch into one buffer by its signature and
    ``input_views`` reads back every array, dtype and shape: a slot batch,
    and an ELL batch whose 600-node graph spills (GIN's W=128 ELL path)."""
    rng = np.random.default_rng(2)
    for gs in (synthetic_molhiv(5, seed=1),
               synthetic_molhiv(3, seed=1) + [random_molecule_graph(rng, num_nodes=600)]):
        stream = cpu_stream("gin", sets=1, node_capacity=1023, edge_capacity=4096,
                            graph_capacity=8)
        batch, _ = stream._make_batch(gs)
        sig = base.batch_signature(batch)
        layout, total = rs.input_layout(sig)
        assert total % rs.ALIGN == 0 and all(off % rs.ALIGN == 0 for *_, off, _ in layout)
        views = rs.input_views(rs.pack_inputs(batch, sig, pin=False), sig)
        assert views.keys() == batch.keys()
        for k, v in batch.items():
            assert views[k].numpy().dtype == v.dtype and np.array_equal(views[k].numpy(), v), k
        assert rs.describe("gin", sig).startswith(
            "gin local_ell W=128" if "loc_ell" in batch else "gin local_slots W=128")


def test_stream_on_an_ell_bucket_matches_the_plain_path():
    """A 600-node graph exceeds every window, so GIN's bucket takes ELL with
    a spill tail (the per-layer path) and GAT's the slots with a spill tail:
    the stream's predictions equal the plain edge-list forward's (1e-5)."""
    rng = np.random.default_rng(5)
    gs = synthetic_molhiv(3, seed=2) + [random_molecule_graph(rng, num_nodes=600)]
    for name in ("gin", "gat"):
        stream = cpu_stream(name, sets=1, node_capacity=1023, edge_capacity=4096)
        got = np.array(list(stream.run([(g, 0) for g in gs])))
        tgs = registry.apply_transforms(stream.spec, gs)
        plain = base.as_batch(pack_graphs(tgs, 1023, 4096 + 1024, 4))
        want = stream.spec.forward(stream.params[0], base.to_device(plain, "cpu"), FLOAT32)
        np.testing.assert_allclose(got, want[:4, 0].numpy(), rtol=1e-5, atol=1e-5)


def test_host_app_runs_on_the_cpu():
    """``host_app.main`` with ``--device cpu`` prints one record with the
    JAX tool's keys and the card's additions (null replay on the CPU)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert host_app.main(["--device", "cpu", "--graphs", "32", "--trials", "1"]) == 0
    (line,) = out.getvalue().splitlines()
    rec = json.loads(line)
    assert rec["metric"] == "gin_host_app_sustained_us_per_graph" and rec["unit"] == "us/graph"
    assert {"value", "sequential_us_per_graph", "pipeline_speedup", "buckets", "dispatches",
            "dispatch_floor_ms", "dispatch_floor_share", "pack_ms_per_bucket",
            "sequential_pack_share", "replay_ms_per_bucket", "device_share",
            "u50_device_only_us", "vs_u50_device_only"} <= set(rec)
    assert rec["buckets"] == rec["dispatches"] == 1 and rec["graphs"] == 32
    assert all(rec[k] > 0 for k in ("value", "sequential_us_per_graph", "pipeline_speedup",
                                    "dispatch_floor_ms", "pack_ms_per_bucket"))
    assert rec["replay_ms_per_bucket"] is None and rec["device_share"] is None
    assert rec["captured_graphs"] == 0 and rec["device"] == "cpu"
    assert "replay not measured" in err.getvalue()


def test_host_ab_runs_on_the_cpu():
    """``host_ab.main`` with ``--device cpu`` prints one record per
    comparison the CPU can make (the H2D one needs a card), two samples a
    side, every sample positive and the wins adding up; its numpy-packer
    stream serves what the stream serves."""
    from flowgnn_tpu_torch.bench import host_ab

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert host_ab.main(["--device", "cpu", "--graphs", "32", "--pairs", "2"]) == 0
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["comparison"] for r in recs] == ["pack", "ell", "stream_pack", "workers"]
    for r in recs:
        a, b = (k for k in r if k.endswith("_wins"))
        sides = [k for k in r if isinstance(r[k], list)]
        assert len(sides) == 2 and all(len(r[k]) == 2 and min(r[k]) > 0 for k in sides)
        assert r[a] + r[b] == 2
    items = [(g, i // 6) for i, g in enumerate(synthetic_molhiv(12, seed=3))]
    want = np.array(list(cpu_stream("gin", graph_capacity=4).run(items)))
    numpy_stream = host_ab.NumpyPackStream(
        "gin", [small_params("gin", s) for s in range(2)], FLOAT32, device="cpu",
        **{**CAPS, "graph_capacity": 4})
    np.testing.assert_array_equal(np.array(list(numpy_stream.run(items))), want)


def test_cuda_stream_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.InferenceStream("gin", [small_params("gin", 0)], FLOAT32)
