"""The port's bench entry (``flowgnn_tpu_torch.bench.bench``) and the kernel
forms it adds, against the JAX package: row 31 (``gin_local_message_ell``)
and row 12's pass-through (``gin_local_message_ell_lanes``, the ELL stage
bench's kernel) through their plain versions against the Pallas kernels in
interpret mode; ``bench.roofline``'s counts against the JAX module's; the
entry's stream (window, block, layout, batches, f32 predictions) against
``bench.py:125-209`` run on the JAX package; and the entry itself, run on
the CPU."""

import contextlib
import io
import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu.bench import roofline as jroof
from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.ops.pallas import local_layer as jll
from flowgnn_tpu_torch.bench import bench, roofline, spmm_stage
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import ELL_LAYER_GEOMETRY, _ell_layer_operands
from test_torch_spill import _assert_batches_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ("molhiv", "molpcba", "hep10k")


def _close(got, want, tol: float) -> None:
    """|got − want| ≤ tol·(scale + |want|), scale the largest |want| (at
    least 1e-2, so an all-small output is still held to its own scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-2, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _spill_operands(seed: int = 21) -> dict:
    """Row 31's operands on a W=128 ELL batch (block 384) of seven
    molhiv-shaped graphs and one of 300 nodes, whose crossing edges ride the
    spill tail after the ELL lanes: the meta holds the ELL lanes only."""
    rng = np.random.default_rng(seed)
    graphs = ts.synthetic_molhiv(7, seed=seed) + [ts.random_molecule_graph(rng, num_nodes=300)]
    packed = tg.pack_graphs_aligned(graphs, window=128, node_capacity=1023, edge_capacity=4096,
                                    graph_capacity=16)
    batch = tb.as_batch(packed, blocked="local_ell", window=128, block=384)
    assert tb.ell_spill_lanes(batch) > 0 and tb.ell_geometry(batch)[1] == 1
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    return dict(ell_meta=tb.ell_meta(tb.to_device(batch, "cpu")).numpy(), h=f32(n, 100),
                ee_table=f32(13, 100), window=128)


def _row31_operands(geometry: str) -> tuple[dict, int]:
    """(row 31's operands as numpy arrays, the layout's k)."""
    if geometry == "spill":
        return _spill_operands(), 1
    ops = _ell_layer_operands("gin_local_layer_ell", geometry)
    return ({k: ops[k] for k in ("ell_meta", "h", "ee_table", "window")},
            ELL_LAYER_GEOMETRY[geometry][2])


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("geometry,wps", [("W128", 1), ("k2", 1), ("W128", 2), ("spill", 1)],
                         ids=["k1", "k2", "wps2", "spill"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_row31_ref_matches_jax(geometry, wps, dtype, tol, monkeypatch):
    """``gin_local_message_ell_ref`` against the JAX ``gin_local_message_ell``
    (row 13's Pallas kernel with a pass-through epilogue, interpret mode) at
    W=128, k=1 and k=2, with two windows a grid step (row 11's form), and on
    a batch with a spill tail, whose lanes neither takes: f32 to 1e-5 of the
    output's scale (summation order only), bf16 to 5e-2 (each lane's message
    rounds before the sum, the output once; the TPU kernel's one-hot sums
    add in another order)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops, k = _row31_operands(geometry)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    meta = ops["ell_meta"]
    got = local_layer.gin_local_message_ell(
        torch.from_numpy(meta), _torch(ops["ee_table"], tdt), _torch(ops["h"], tdt), ops["window"])
    want = jll.gin_local_message_ell(
        jnp.asarray(meta[:, 2:]), jnp.asarray(ops["ee_table"], jdt), jnp.asarray(meta[:, 0]),
        jnp.asarray(meta[:, 1]), jnp.asarray(ops["h"], jdt), ops["window"], k, wps=wps)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert np.abs(want).max() > 1e-1
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("geometry", ["W128", "k2", "W512"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_pass_through_ref_matches_jax(geometry, dtype, tol, monkeypatch):
    """``gin_local_message_ell_lanes_ref`` (row 12's pass-through) against
    the JAX ``local_scatter_apply_ell`` with the ELL stage bench's epilogue
    (``flowgnn_tpu/bench/spmm_stage.py:84-85``: acc + m_spill), seeded
    non-zero per-lane ``ee`` and ``m_spill``, h over the padded windows as
    the bench runs it; tolerances as for row 31."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _ell_layer_operands("gin_local_layer_ell", geometry)
    meta, w, k = ops["ell_meta"], ops["window"], ELL_LAYER_GEOMETRY[geometry][2]
    rng = np.random.default_rng(5)
    rows = -(-ops["h"].shape[0] // w) * w
    d = ops["h"].shape[1]
    h = rng.normal(0, 0.3, (rows, d)).astype(np.float32)
    ee = rng.normal(0, 0.3, (meta.shape[0], d)).astype(np.float32)
    spill = rng.normal(0, 0.3, (rows, d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = local_layer.gin_local_message_ell_lanes(
        _torch(ee, tdt), torch.from_numpy(meta), _torch(h, tdt), _torch(spill, tdt), w)
    want = jll.local_scatter_apply_ell(
        jnp.asarray(ee, jdt), jnp.asarray(meta[:, 0]), jnp.asarray(meta[:, 1]),
        jnp.asarray(h, jdt), jnp.asarray(spill, jdt), (),
        lambda acc, h_win, spill_win: acc + spill_win.astype(jnp.float32), w, k, d)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got.float().numpy(), want, tol)
    # Without m_spill the sums alone: the JAX stage's zeros.
    none = local_layer.gin_local_message_ell_lanes(
        _torch(ee, tdt), torch.from_numpy(meta), _torch(h, tdt), None, w)
    zero = local_layer.gin_local_message_ell_lanes(
        _torch(ee, tdt), torch.from_numpy(meta), _torch(h, tdt), torch.zeros(rows, d, dtype=tdt),
        w)
    assert torch.equal(none, zero)


def test_roofline_counts_match_jax():
    """``model_cost``, ``spmm_cost`` and ``report`` give the JAX module's
    figures for all six models at the JAX module's chip, and ``report``
    defaults to the H100."""
    v5e = roofline.ChipSpec(name=jroof.V5E.name, peak_bf16_flops=jroof.V5E.peak_bf16_flops,
                            peak_f32_flops=jroof.V5E.peak_f32_flops, hbm_gbps=jroof.V5E.hbm_gbps)
    for name in ("gin", "gin-vn", "gcn", "gat", "pna", "dgn"):
        for n, e, b in ((32768, 70000, 2), (1000, 3000, 4)):
            got, want = roofline.model_cost(name, n, e, b), jroof.model_cost(name, n, e, b)
            assert (got.flops, got.bytes) == (want.flops, want.bytes)
        for bf16 in (True, False):
            assert roofline.report(name, 30000, 65000, 1.7e-3, bf16, v5e) == jroof.report(
                name, 30000, 65000, 1.7e-3, bf16)
        cost = roofline.model_cost(name, 30000, 65000)
        assert roofline.report(name, 30000, 65000, 1e-3)["light_speed_us"] == pytest.approx(
            cost.light_speed_s(roofline.H100) * 1e6)
    got, want = roofline.spmm_cost(98304, 128, 100), jroof.spmm_cost(98304, 128, 100)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    with pytest.raises(KeyError):
        roofline.model_cost("mlp", 1, 1)


def _jax_stream(name: str, args, monkeypatch) -> dict:
    """``bench.py:125-209`` on the JAX package: the window, the block, the
    layout and the batches it picks for ``args``."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    spec = jr.get(name)
    graphs = jr.apply_transforms(spec, js.synthetic_dataset(
        args.dataset, seed=0, with_eigen=spec.needs_eigen, num_graphs=args.graphs))
    auto_w, auto_b = jb.choose_geometry(name, max(g.num_nodes for g in graphs))
    ell_w = args.ell_window or auto_w
    if args.ell_window and not args.ell_block:
        gw, gb = jb.ELL_GEOMETRY_DEFAULTS.get(name, (512, 1536))
        ell_b = auto_b if ell_w == auto_w else -(-(gb * ell_w) // (gw * 128)) * 128
    else:
        ell_b = args.ell_block or auto_b
    buckets = list(jg.pack_dataset(
        graphs, node_capacity=args.node_cap,
        edge_capacity=args.edge_cap or jg.auto_edge_capacity(graphs, args.node_cap),
        graph_capacity=args.graph_cap, with_eigen=spec.needs_eigen, align_window=ell_w))
    slot_fits = max(g.num_nodes for g in graphs) <= ell_w
    blocked = "local_slots" if (name in ("pna", "gat", "dgn") or slot_fits) else "local_ell"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batches = jb.as_batches_uniform(buckets, blocked=blocked, window=ell_w, block=ell_b)
        if (blocked == "local_slots" and name in ("gin", "gcn", "gin-vn")
                and any(b["slot_spill"].shape[-1] > 0 for b in batches)):
            blocked = "local_ell"
            batches = jb.as_batches_uniform(buckets, blocked=blocked, window=ell_w, block=ell_b)
    return dict(buckets=buckets, batches=batches, window=ell_w, block=ell_b, layout=blocked)


# (model, dataset, extra flags): GAT at the port's W=128 on both sides (the
# JAX package's default is 384, a stated departure), and GIN on hep10k at
# W=128, whose slot stream spills and falls back to ELL.
STREAM_CASES = [(m, d, []) for m in ("gin", "gcn", "pna") for d in DATASETS]
STREAM_CASES += [("gat", d, ["--ell-window", "128"]) for d in ("molhiv", "molpcba")]
STREAM_CASES += [("gin", "hep10k", ["--ell-window", "128"])]


@pytest.mark.parametrize("name,dataset,flags", STREAM_CASES,
                         ids=[f"{m}-{d}{'-w128' if f else ''}" for m, d, f in STREAM_CASES])
def test_entry_stream_matches_bench_py(name, dataset, flags, monkeypatch):
    """The entry's stream at a few dozen graphs (buckets of 1024 node rows)
    against ``bench.py``'s on the JAX package: the same window, block and
    layout (the ELL fallback of GIN's spilling hep10k slot stream at W=128
    included), the batches key by key, and the f32 predictions of the
    port's forward on the entry's batches against the JAX forward on the
    plain batches of the same packing (1e-5; synthetic weights, seed 0)."""
    graphs = 12 if dataset == "hep10k" else 24
    args = bench.parse_args(["--dataset", dataset, "--graphs", str(graphs), "--node-cap", "1023",
                             "--graph-cap", "64", *flags])
    got, want = bench.stream(name, args), _jax_stream(name, args, monkeypatch)
    assert (got["window"], got["block"], got["layout"]) == (
        want["window"], want["block"], want["layout"])
    if flags and name == "gin":
        assert got["layout"] == "local_ell"
        assert any(tb.ell_spill_lanes(b) for b in got["batches"])
    assert len(got["batches"]) == len(want["batches"])
    for jbatch, tbatch in zip(want["batches"], got["batches"]):
        _assert_batches_equal(jbatch, tbatch)
    params = bench.load_params(name, args)
    p32 = loaders.params_from_numpy(params, tn.FLOAT32, "cpu")
    jp = jb.prepare_params(params, jn.FLOAT32)
    forward, jforward = tr.get(name).forward, jr.get(name).forward
    for packed, tbatch in zip(want["buckets"], got["batches"]):
        out = forward(p32, tb.to_device(tbatch, "cpu"), tn.FLOAT32)
        ref = np.asarray(jforward(jp, jb.as_batch(packed), jn.FLOAT32))
        k = packed.num_graphs
        assert np.isfinite(ref[:k]).all() and np.ptp(ref[:k]) > 1e-4
        _close(out[:k].numpy(), ref[:k], 1e-5)


def _records(stdout: str) -> list[dict]:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def test_entry_runs_on_the_cpu():
    """``python -m flowgnn_tpu_torch.bench.bench --device cpu`` prints one
    record with ``bench.py``'s four keys and ``detail``; its graph replay is
    null on the CPU, and stderr says why; without a card and without
    ``--device cpu`` the entry exits non-zero and prints no record."""
    cmd = [sys.executable, "-m", "flowgnn_tpu_torch.bench.bench"]
    proc = subprocess.run(cmd + ["--device", "cpu", "--model", "gin", "--graphs", "32",
                                 "--trials", "1", "--reps", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (rec,) = _records(proc.stdout)
    assert rec["metric"] == "gin_molhiv_synth_us_per_graph" and rec["unit"] == "us/graph"
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    d = rec["detail"]
    assert rec["value"] > 0  # vs_baseline is rounded as bench.py rounds it
    assert rec["vs_baseline"] == pytest.approx(49.5 / rec["value"], abs=1e-3)
    assert d["graph_us_per_graph"] is None and d["device_share"] is None
    assert d["sm_clock_mhz"] is None and d["spmm_time_us"] > 0
    assert (d["layout"], d["window"], d["weights"], d["buckets"]) == (
        "local_slots", 128, "synthetic", 1)
    assert all(d[k] > 0 for k in ("us_per_graph_avg", "graphs_per_s", "edges_per_s",
                                  "roofline_frac", "achieved_tflops", "dispatch_floor_ms",
                                  "h2d_ms", "spmm_roofline_frac"))
    assert "graph replay not measured (CUDA graphs need a card)" in proc.stderr
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd + ["--model", "gin", "--graphs", "8"], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and not _records(proc.stdout)


def test_entry_all_models_ends_in_the_geomean_line():
    """With ``--model all`` each model's record comes first and the last
    line is the geometric-mean speedup over the U50 with each model's
    figures; the ELL stage bench runs on an ELL stream (GIN at W=128 on
    hep10k-shaped graphs)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert bench.main(["--device", "cpu", "--graphs", "16", "--node-cap", "1023",
                           "--trials", "1", "--reps", "1"]) == 0
    recs = _records(out.getvalue())
    names = list(bench.BASELINES_US["molhiv"])
    assert [r["metric"] for r in recs] == (
        [f"{m}_molhiv_synth_us_per_graph" for m in names] + ["all_molhiv_synth_geomean_speedup"])
    last = recs[-1]
    assert set(last["models"]) == set(names) and last["unit"] == "x_vs_u50"
    base = bench.BASELINES_US["molhiv"]
    gm = np.exp(np.mean([np.log(base[m] / r["value"]) for m, r in zip(names, recs)]))
    assert last["value"] == pytest.approx(gm, abs=1e-3)
    before = local_layer.gin_local_message_ell_lanes.launches
    args = bench.parse_args(["--dataset", "hep10k", "--graphs", "12", "--node-cap", "1023",
                             "--ell-window", "128", "--device", "cpu"])
    s = bench.stream("gin", args)
    batches = [tb.to_device(b, "cpu") for b in s["batches"]]
    stage = spmm_stage.measure_spmm_stage(batches, tn.BF16, reps=1, trials=1)
    assert s["layout"] == "local_ell" and stage["time_us"] > 0 and stage["roofline_frac"] > 0
    assert stage["sampled_buckets"] == list(range(len(batches)))
    assert local_layer.gin_local_message_ell_lanes.launches == before  # CPU: nothing launched
