"""The port's OGB converter (``core/ogb.py``), its metrics
(``bench/metrics.py``) and ``cli accuracy`` against the JAX package: the
converter writes byte-identical datasets from the same raw directory, the
metrics equal the JAX functions on hypothesis-drawn inputs, and the
accuracy scores equal the JAX forward's on the plain edge list (f32)."""

import argparse
import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from flowgnn_tpu.bench import metrics as jmetrics
from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import io as jio
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import ogb as jogb
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch import cli
from flowgnn_tpu_torch.bench import metrics
from flowgnn_tpu_torch.bench.bench import load_params
from flowgnn_tpu_torch.core import io as tio
from flowgnn_tpu_torch.core import ogb
from flowgnn_tpu_torch.core.numerics import FLOAT32
from flowgnn_tpu_torch.core.synthetic import synthetic_molhiv


def _raw(tmp_path, n=8, tasks=1, blanks=False, gz=False, edge_feat=True, seed=1) -> str:
    """An OGB raw/ directory of ``n`` seeded molhiv-shaped graphs with
    binary labels, ``tasks`` of them a graph, some blank with ``blanks``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, (n, tasks)).astype(np.float64)
    labels[:2, 0] = [0, 1]  # both classes in task 0
    if blanks:
        labels[rng.random((n, tasks)) < 0.3] = np.nan
        labels[0, 0], labels[1, 0] = 0, 1
    raw = tmp_path / f"raw{seed}"
    ogb.write_ogb_raw(str(raw), synthetic_molhiv(n, seed=seed), labels, gz=gz,
                      edge_feat=edge_feat)
    return str(raw)


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


CONVERT_CASES = [  # (gz, edge-feat.csv, --eigen, --limit, tasks, blanks)
    (False, True, False, None, 1, False),
    (True, True, True, None, 2, True),
    (False, False, False, 5, 2, True),
    (True, False, True, 6, 1, False),
]


@pytest.mark.parametrize("gz,edge_feat,eigen,limit,tasks,blanks", CONVERT_CASES,
                         ids=["csv", "gz-eigen-blanks", "no-edge-feat-limit", "gz-no-edge-feat"])
def test_convert_byte_identical_to_jax(tmp_path, gz, edge_feat, eigen, limit, tasks, blanks):
    """``cli convert`` (the port's ``convert_ogb``) and the JAX converter on
    one raw directory write the same files, byte for byte: plain and
    gzipped CSVs, with and without ``edge-feat.csv`` (zero bond features),
    with Laplacian eigenvectors, a ``--limit``, and blank labels (NaN)."""
    raw = _raw(tmp_path, tasks=tasks, blanks=blanks, gz=gz, edge_feat=edge_feat)
    argv = ["convert", "--raw", raw, "--out", str(tmp_path / "port")]
    argv += ["--eigen"] * eigen + (["--limit", str(limit)] if limit else [])
    with contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv)
    n = jogb.convert_ogb(raw, str(tmp_path / "jax"), with_eigen=eigen, limit=limit)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert n == (limit or 8) and len(want) == n * (4 + eigen) + 2
    assert got == want
    labels = ogb.load_labels(str(tmp_path / "port"))
    assert labels.shape == (n, tasks) and np.isnan(labels).any() == blanks
    back = list(tio.read_dataset(str(tmp_path / "port"), with_eigen=eigen))
    graphs = synthetic_molhiv(8, seed=1)[:n]
    for g0, g1 in zip(graphs, back):
        np.testing.assert_array_equal(g0.node_feat, g1.node_feat)
        np.testing.assert_array_equal(g0.edge_index, g1.edge_index)
        np.testing.assert_array_equal(g1.edge_attr, g0.edge_attr if edge_feat else 0 * g0.edge_attr)


def test_load_ogb_raw_matches_jax(tmp_path):
    """``load_ogb_raw`` gives the JAX reader's graphs and labels (NaN where
    blank), eigenvectors included."""
    raw = _raw(tmp_path, n=6, tasks=3, blanks=True, gz=True)
    got, got_labels = ogb.load_ogb_raw(raw, with_eigen=True, limit=5)
    want, want_labels = jogb.load_ogb_raw(raw, with_eigen=True, limit=5)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert np.isnan(got_labels).any() and len(got) == 5
    for a, b in zip(got, want):
        for k in ("node_feat", "edge_index", "edge_attr", "node_eigen"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


labels_st = st.lists(st.sampled_from([0.0, 1.0, float("nan")]), min_size=1, max_size=40)


@settings(max_examples=200, deadline=None)
@given(labels=labels_st, data=st.data())
def test_metrics_match_jax(labels, data):
    """ROC-AUC and AP equal the JAX functions to 1e-12, NaN where they give
    NaN: hypothesis draws labels (0, 1 or NaN; one class may be absent) and
    scores from a few values, so that ties are common."""
    scores = data.draw(st.lists(st.sampled_from([-1.5, -0.25, 0.0, 0.25, 0.5, 3.0]),
                                min_size=len(labels), max_size=len(labels)))
    y, s = np.array(labels), np.array(scores)
    finite = y[~np.isnan(y)]
    for port, ref, yy, ss in ((metrics.roc_auc, jmetrics.roc_auc, finite, s[~np.isnan(y)]),
                              (metrics.average_precision, jmetrics.average_precision, y, s)):
        got, want = port(yy, ss), ref(yy, ss)
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert abs(got - want) <= 1e-12


def test_metrics_ties_and_absent_class():
    """Tied scores take their average rank; either class absent gives NaN."""
    assert metrics.roc_auc([0, 1, 0, 1], [0.5, 0.5, 0.5, 0.5]) == 0.5
    assert metrics.roc_auc([0, 1, 1], [0.1, 0.2, 0.2]) == 1.0
    assert np.isnan(metrics.roc_auc([1, 1], [0.1, 0.2]))
    assert np.isnan(metrics.average_precision([0, np.nan], [0.1, 0.2]))
    assert metrics.average_precision([1, np.nan, 0], [0.9, 5.0, 0.1]) == 1.0


def _jax_scores(name: str, graphs) -> np.ndarray:
    """The JAX forward's task-0 scores of ``graphs`` (JAX graphs, not yet
    transformed) on the plain edge list, f32, synthetic weights seed 0."""
    spec = jr.get(name)
    graphs = jr.apply_transforms(spec, graphs)
    packed = jg.pack_graphs(graphs, node_capacity=2047, edge_capacity=8192,
                            graph_capacity=len(graphs) + 1, with_eigen=spec.needs_eigen)
    jp = jb.prepare_params(load_params(name, argparse.Namespace(weights="synthetic", seed=0)),
                           jn.FLOAT32)
    out = jax.jit(lambda p, b: spec.forward(p, b, jn.FLOAT32))(jp, jb.as_batch(packed))
    return np.asarray(out)[: len(graphs), 0]


ACCURACY_CASES = [  # (model, dataset kind, --metric, the metric it resolves to)
    ("gin", "converted", "auto", "rocauc"),
    ("dgn", "converted", "rocauc", "rocauc"),
    ("gin", "raw", "ap", "ap"),
]


@pytest.mark.parametrize("name,kind,metric,resolved", ACCURACY_CASES,
                         ids=["gin-rocauc", "dgn-rocauc", "gin-ap-two-task"])
def test_accuracy_matches_jax(tmp_path, name, kind, metric, resolved):
    """``cli accuracy --f32 --device cpu``: the scores equal the JAX
    forward's on the plain edge list at f32 1e-5 (the port's through its
    layout policy's stream, whose kernels' plain versions run here); the
    metric equals the JAX metric function on the port's scores to 1e-12.
    A converted dataset with one task (DGN's with eigenvectors), and an OGB
    raw/ directory with two tasks and blank labels, scored on task 0 with
    the note on stderr."""
    raw = _raw(tmp_path, n=16, tasks=2 if kind == "raw" else 1, blanks=kind == "raw", seed=3)
    dataset = raw
    if kind == "converted":
        dataset = str(tmp_path / "ds")
        jogb.convert_ogb(raw, dataset, with_eigen=name == "dgn")
    scores, labels = cli.accuracy_scores(name, dataset, FLOAT32, device="cpu")
    if kind == "converted":  # DGN's eigenvectors as the files hold them (4 digits)
        jgraphs = list(jio.read_dataset(dataset, with_eigen=jr.get(name).needs_eigen))
    else:
        jgraphs, _ = jogb.load_ogb_raw(raw)
    want = _jax_scores(name, jgraphs)
    scale = max(1e-2, float(np.abs(want).max()))
    assert np.ptp(want) > 1e-4
    np.testing.assert_allclose(scores / scale, want / scale, rtol=1e-5, atol=1e-5)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(["accuracy", "--model", name, "--dataset", dataset, "--metric", metric,
                  "--f32", "--device", "cpu"])
    rec = json.loads(out.getvalue().splitlines()[-1])
    assert set(rec) == {"model", "dataset", "metric", "value", "num_graphs", "weights"}
    assert (rec["model"], rec["metric"], rec["num_graphs"], rec["weights"]) == (
        name, resolved, 16, "synthetic")
    fn = jmetrics.average_precision if resolved == "ap" else jmetrics.roc_auc
    ref = fn(labels[:, 0], scores)
    assert np.isfinite(ref) and abs(rec["value"] - ref) <= 1e-12
    assert "measures no trained model" in err.getvalue()
    assert ("scoring task 0" in err.getvalue()) == (kind == "raw")


def test_accuracy_without_labels_raises(tmp_path):
    """A reference-layout directory without ``labels.csv`` raises the JAX
    CLI's ``SystemExit``, naming the port's ``convert``."""
    tio.write_dataset(str(tmp_path / "ds"), synthetic_molhiv(3, seed=0))
    with pytest.raises(SystemExit, match="flowgnn_tpu_torch.cli convert"):
        cli.run_accuracy("gin", str(tmp_path / "ds"), FLOAT32, device="cpu")
