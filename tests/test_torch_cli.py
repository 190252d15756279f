"""The port's experiment CLI (``flowgnn_tpu_torch.cli``) and what it brings
along (``bench/profiling.py``, ``bench/tune.py``, ``ops.segment.
segment_mean``, ``core.graphs.add_virtual_node``) against the JAX package,
on the CPU with seeded synthetic weights (no reference tree): ``run_case``'s
predictions against the JAX forward of the same weights on the same graphs
(f32 1e-5) for all six models on every layout, its files against the JAX
CLI's formats, the parser against the JAX parser, the profiler's trace and
its errors, the window sweep's arithmetic and its skips."""

import argparse
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flowgnn_tpu import cli as jcli
from flowgnn_tpu.bench import profiling as jprof
from flowgnn_tpu.bench import tune as jtune
from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import io as jio
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.ops import segment as jseg
from flowgnn_tpu_torch import cli
from flowgnn_tpu_torch.bench import profiling, protocol, tune
from flowgnn_tpu_torch.bench.bench import load_params
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import io as tio
from flowgnn_tpu_torch.core.numerics import FLOAT32
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_dataset
from flowgnn_tpu_torch.models import gin
from flowgnn_tpu_torch.ops import segment
from flowgnn_tpu_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("gin", "gin-vn", "gcn", "gat", "pna", "dgn")
CAPS = (511, 2048, 8)  # small buckets: 12 molhiv-shaped graphs make two
N_GRAPHS = 12
JAX_KEYS = {"model", "dataset", "num_graphs", "avg_ms", "ms_per_graph", "graphs_per_s"}
LINE = re.compile(r"^g(\d+): (-?\d+\.\d{8})$")


def _hub_dataset(root) -> str:
    """A reference-layout dataset of six molhiv-shaped graphs and one whose
    node 0 takes 12 in-edges, past the 8 slots: its slot stream spills."""
    rng = np.random.default_rng(5)
    hub = random_molecule_graph(rng, num_nodes=30)
    extra = np.stack([np.arange(1, 13), np.zeros(12, int)], 1).astype(np.int32)
    hub = tg.Graph(hub.node_feat, np.concatenate([hub.edge_index, extra]),
                   np.concatenate([hub.edge_attr, np.zeros((12, 3), np.int32)]))
    path = str(root / "hub")
    tio.write_dataset(path, synthetic_dataset("molhiv", seed=2, num_graphs=6) + [hub])
    return path


@functools.cache
def _jax_predictions(name: str, dataset: str) -> np.ndarray:
    """The JAX forward's predictions (f32, synthetic weights seed 0) of the
    dataset's graphs on the plain edge list, in order."""
    spec = jr.get(name)
    if dataset == "synth":
        graphs = js.synthetic_molhiv(N_GRAPHS, seed=0, with_eigen=spec.needs_eigen)
    else:
        graphs = list(jio.read_dataset(dataset, with_eigen=spec.needs_eigen))
    graphs = jr.apply_transforms(spec, graphs)
    packed = jg.pack_graphs(graphs, node_capacity=1023, edge_capacity=4096,
                            graph_capacity=len(graphs) + 1, with_eigen=spec.needs_eigen)
    jp = jb.prepare_params(load_params(name, argparse.Namespace(weights="synthetic", seed=0)),
                           jn.FLOAT32)
    out = jax.jit(lambda p, b: spec.forward(p, b, jn.FLOAT32))(jp, jb.as_batch(packed))
    return np.asarray(out)[: len(graphs), 0]


def _read_predictions(path) -> np.ndarray:
    lines = open(path).read().splitlines()
    matches = [LINE.match(ln) for ln in lines]
    assert all(matches) and [int(m[1]) for m in matches] == list(range(1, len(lines) + 1))
    return np.array([float(m[2]) for m in matches])


def _close(got, want, tol=1e-5) -> None:
    scale = max(1e-2, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


RUN_CASES = [(m, lay, "synth") for m in MODELS for lay in ("plain", "blocked", "local")]
RUN_CASES += [("gin", "local", "hub"), ("gcn", "local", "hub")]


@pytest.mark.parametrize("name,layout,dataset", RUN_CASES,
                         ids=[f"{m}-{lay}-{d}" for m, lay, d in RUN_CASES])
def test_run_case_matches_jax(tmp_path, name, layout, dataset):
    """``run_case(device="cpu")`` in f32: ``<model>_output.txt`` holds one
    ``g%d: %.8f`` line a graph in submission order, equal to the JAX forward
    of the same weights on the same graphs at 1e-5; the record has the JAX
    keys and the layout the policy chose (slots on molhiv-shaped graphs; ELL
    for GIN and GCN on a dataset directory whose hub node spills its slots)."""
    ds = _hub_dataset(tmp_path) if dataset == "hub" else "synth"
    r = cli.run_case(name, ds, 1, str(tmp_path / "out"), FLOAT32, num_graphs=None if
                     dataset == "hub" else N_GRAPHS, caps=CAPS, layout=layout, device="cpu")
    want = _jax_predictions(name, ds)
    got = _read_predictions(tmp_path / "out" / f"{name}_output.txt")
    assert got.shape == want.shape and np.ptp(want) > 1e-4
    _close(got, want)
    assert JAX_KEYS <= set(r) and r["num_graphs"] == len(want)
    assert r["buckets"] == (2 if dataset == "synth" else 1)
    expect = {"plain": "plain", "blocked": "blocked",
              "local": "local_ell" if dataset == "hub" else "local_slots"}[layout]
    assert (r["layout"], r["window"], r["weights"]) == (
        expect, {"plain": None}.get(layout, 128), "synthetic")


def test_run_case_files_match_jax_formats(tmp_path, monkeypatch):
    """``summary.<model>.csv`` equals, line for line, the JAX ``KernelStats``
    fed the same trial times; the record's figures follow from them as the
    JAX CLI computes them; ``--trace`` wraps the trials in
    ``profiling.trace``, which writes a Chrome trace of them."""
    made = []

    class Recorder(profiling.KernelStats):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(profiling, "KernelStats", Recorder)
    r = cli.run_case("gcn", "synth", 3, str(tmp_path), FLOAT32, num_graphs=6, caps=CAPS,
                     device="cpu", trace_dir=str(tmp_path / "trace"))
    (stats,) = made
    want = jprof.KernelStats("gcn_compute_graphs", times_s=list(stats.times_s)).csv()
    assert len(stats.times_s) == 3
    assert (tmp_path / "summary.gcn.csv").read_text().splitlines() == want.splitlines()
    assert r["avg_ms"] == pytest.approx(np.mean(stats.times_s) * 1e3, rel=1e-12)
    assert r["ms_per_graph"] == pytest.approx(r["avg_ms"] / 6, rel=1e-12)
    assert r["graphs_per_s"] == pytest.approx(6 / (r["avg_ms"] / 1e3), rel=1e-12)
    (trace,) = os.listdir(tmp_path / "trace")
    events = json.load(open(tmp_path / "trace" / trace))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_main_run_writes_results_json(tmp_path):
    """``main(["run", ...])`` writes results.json, one record a model with the
    JAX keys and the port's layout, window and weights, and the JAX stderr
    line; ``--pallas`` is ``--layout blocked``."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli.main(["run", "--device", "cpu", "--f32", "--model", "gin", "--num-graphs", "6",
                  "--trials", "2", "--pallas", "--node-cap", "511", "--out", str(tmp_path)])
    (rec,) = json.load(open(tmp_path / "results.json"))
    assert set(rec) == JAX_KEYS | {"layout", "window", "weights", "buckets"}
    assert (rec["model"], rec["dataset"], rec["num_graphs"], rec["layout"]) == (
        "gin", "synth", 6, "blocked")
    assert re.search(r"gin on synth: [\d.]+ us/graph \(\d+ graphs/s\)", err.getvalue())
    assert len(_read_predictions(tmp_path / "gin_output.txt")) == 6


def test_cli_module_runs_on_the_cpu(tmp_path):
    """``python -m flowgnn_tpu_torch.cli run --device cpu --f32 --model gin
    --num-graphs 32 --trials 1`` writes its three files; without a card and
    without ``--device cpu`` the same command exits non-zero before writing
    any."""
    cmd = [sys.executable, "-m", "flowgnn_tpu_torch.cli", "run", "--model", "gin",
           "--num-graphs", "32", "--trials", "1"]
    proc = subprocess.run(cmd + ["--device", "cpu", "--f32", "--out", str(tmp_path / "a")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(_read_predictions(tmp_path / "a" / "gin_output.txt")) == 32
    assert sorted(os.listdir(tmp_path / "a")) == ["gin_output.txt", "results.json",
                                                  "summary.gin.csv"]
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd + ["--out", str(tmp_path / "b")], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and not (tmp_path / "b").exists()


def _options(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])--[a-z0-9][a-z0-9-]*", help_text))


@pytest.mark.parametrize("cmd", ["run", "accuracy", "convert", "tune"])
def test_parser_has_every_jax_option(cmd):
    """Every option of each JAX subcommand is in the port's (the port adds
    ``--device``, ``--weights``, ``--seed`` to those that run a model)."""
    helps = []
    for main in (jcli.main, cli.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
            main([cmd, "--help"])
        assert e.value.code == 0
        helps.append(_options(out.getvalue()))
    want, got = helps
    assert "--help" in want and want <= got
    assert got - want == (set() if cmd == "convert" else {"--device", "--weights", "--seed"})


@pytest.mark.parametrize("flags", [["--multihost"], ["--edge-shards", "2"], ["--local-data", "4"]],
                         ids=["multihost", "edge-shards", "local-data"])
def test_multihost_is_a_parser_error(tmp_path, flags):
    """Multi-host exits with a parser error naming the missing port; it
    does not fall back to one device."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        cli.main(["run", "--device", "cpu", "--model", "gin", "--out", str(tmp_path), *flags])
    assert e.value.code == 2 and "parallel/" in err.getvalue()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv", [["run", "--model", "gin", "--num-graphs", "4"],
                                  ["accuracy", "--model", "gin", "--dataset", "nowhere"],
                                  ["tune", "--model", "gin", "--num-graphs", "4"]],
                         ids=["run", "accuracy", "tune"])
def test_main_needs_a_card_or_device_cpu(tmp_path, argv):
    """Without a card and without ``--device cpu`` each subcommand that runs
    a model exits non-zero before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv + (["--out", str(tmp_path / "o")] if argv[0] == "run" else []))
    assert e.value.code not in (0, None) and not (tmp_path / "o").exists()


def test_reference_weights_missing_raise(tmp_path):
    """``--weights reference`` without ``--reference`` is a parser error;
    with a tree lacking the model's directory ``run_case`` raises
    ``FileNotFoundError`` naming it."""
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["run", "--device", "cpu", "--weights", "reference", "--out", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="GCN"):
        cli.run_case("gcn", "synth", 1, str(tmp_path), FLOAT32, str(tmp_path), num_graphs=2,
                     device="cpu", weights="reference")


def test_trace_none_does_nothing(tmp_path, monkeypatch):
    """``trace(None)`` starts no profiler and writes nothing."""
    def refuse(*a, **k):
        raise AssertionError("profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(dir)`` on the CPU creates ``dir`` and writes one Chrome trace
    that holds an operator run inside the region."""
    logdir = tmp_path / "a" / "b"
    with profiling.trace(str(logdir), "cpu"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (name,) = os.listdir(logdir)
    events = json.load(open(logdir / name))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_propagates_the_region_error(tmp_path):
    """An exception raised inside the region comes out as itself (the JAX
    ``trace`` turns it into contextlib's RuntimeError)."""
    with pytest.raises(ValueError, match="inside the region"):
        with profiling.trace(str(tmp_path), "cpu"):
            raise ValueError("inside the region")


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    """A profiler that fails to start raises; the region does not run
    untraced."""
    ran = []

    class Broken:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError("profiler unavailable")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(str(tmp_path), "cpu"):
            ran.append(1)
    assert not ran


@functools.cache
def _packed(profile: str, window: int) -> tuple:
    """(port bucket, JAX bucket) of the same 24 graphs of ``profile``,
    packed aligned to ``window``."""
    kw = dict(node_capacity=4095, edge_capacity=16384, graph_capacity=32, align_window=window)
    port = next(tg.pack_dataset(synthetic_dataset(profile, seed=1, num_graphs=24), **kw))
    want = next(jg.pack_dataset(js.synthetic_dataset(profile, seed=1, num_graphs=24), **kw))
    return port, want


@pytest.mark.parametrize("profile", ["molhiv", "hep10k"])
@pytest.mark.parametrize("window", [128, 256, 512])
def test_window_densities_and_blocks_match_jax(profile, window):
    """``_window_densities`` and ``block_candidates`` equal the JAX sweep's
    on the same packed bucket."""
    port, want = _packed(profile, window)
    np.testing.assert_array_equal(tune._window_densities(port, window),
                                  jtune._window_densities(want, window))
    assert tune.block_candidates(port, window) == jtune.block_candidates(want, window)


def test_sweep_on_the_cpu_ranks_its_records():
    """``sweep(device="cpu")`` over two windows, one rep: GIN (ELL) times
    two blocks a window, GAT (slots) one geometry a window; records ranked
    by µs/graph, the winner printed as a GEOMETRY_DEFAULTS entry."""
    for name, n in (("gin", 4), ("gat", 2)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            out = tune.sweep(name, num_graphs=8, windows=(128, 256), reps=1, trials=1,
                             f32=True, device="cpu")
        res = out["results"]
        assert (out["model"], out["dataset"], len(res)) == (name, "molhiv", n)
        us = [r["us_per_graph"] for r in res]
        assert us == sorted(us) and all(np.isfinite(us)) and min(us) > 0
        assert {r["window"] for r in res} == {128, 256}
        assert all((r["block"] is None) == (name == "gat") for r in res)
        assert f'# best: "{name}": ({res[0]["window"]}, ' in err.getvalue()


def test_sweep_skips_a_refused_geometry(monkeypatch):
    """A ``ValueError`` from a wrapper (its geometry check, before any
    launch) skips that geometry with a line on stderr; the rest is timed."""
    real = gin.gin_local_model

    def refuse_256(**ops):
        if ops["window"] == 256:
            raise ValueError("window 256 refused")
        return real(**ops)

    monkeypatch.setattr(gin, "gin_local_model", refuse_256)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = tune.sweep("gin", num_graphs=8, windows=(128, 256), reps=1, trials=1, f32=True,
                         device="cpu")
    assert {r["window"] for r in out["results"]} == {128}
    assert err.getvalue().count("refused (window 256 refused)") == 2


def test_sweep_propagates_other_errors(monkeypatch):
    """Any other exception (a CUDA error, a failed build) propagates."""
    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(protocol, "time_stream", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"), \
            contextlib.redirect_stderr(io.StringIO()):
        tune.sweep("gat", num_graphs=4, windows=(128, 256), reps=1, trials=1, device="cpu")


@pytest.mark.parametrize("shape", [(40,), (40, 3), (40, 2, 5)])
def test_segment_mean_matches_jax(shape):
    """``segment_mean`` equals the JAX function (f64), empty segments 0."""
    rng = np.random.default_rng(len(shape))
    data = rng.normal(size=shape)
    ids = rng.integers(0, 9, shape[0])  # segment 9 stays empty
    got = segment.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 10)
    want = np.asarray(jseg.segment_mean(jax.numpy.asarray(data), jax.numpy.asarray(ids), 10))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert not got[9].any()


def test_add_virtual_node_matches_jax_and_native():
    """``add_virtual_node`` equals the JAX transform and the native one
    (``runtime.native.add_virtual_node_native``), with and without bond
    attributes."""
    rng = np.random.default_rng(3)
    for g in (random_molecule_graph(rng, num_nodes=17), random_molecule_graph(rng, num_nodes=5)):
        for attr in (g.edge_attr, None):
            g = tg.Graph(g.node_feat, g.edge_index, attr)
            got = tg.add_virtual_node(g)
            want = jg.add_virtual_node(jg.Graph(g.node_feat, g.edge_index, attr))
            nat = native.add_virtual_node_native(g)
            for k in ("node_feat", "edge_index", "edge_attr"):
                a, b, c = getattr(got, k), getattr(want, k), getattr(nat, k)
                if b is None:
                    assert a is None and c is None
                else:
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a, c)
            assert got.num_nodes == g.num_nodes + 1
