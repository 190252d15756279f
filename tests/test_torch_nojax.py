"""The port runs without jax: in a fresh interpreter where ``import jax`` and
``import ml_dtypes`` fail, every module of flowgnn_tpu_torch imports, all
six models (GIN, GIN-VN, GCN, GAT, PNA, DGN) run their slot branch on the
CPU, with and without a spill tail (a 200-node graph at W=128), and an ELL
batch, with and without a spill tail (the whole-model or per-layer ELL
path; PNA's plain loop), an edge-block batch (the windowed scatter; GIN's
fused layer), a legacy local batch whose 200-node graph crosses windows
(GIN's and GIN-VN's row 10, the other models' plain loop) and GAT's fused
ELL layer; the bench tools (``bench.matmul_shapes``, ``bench.ablate_gat_mega``,
the stage-split tools ``bench.ablate_gin_slots``, ``ablate_gat_pairs``,
``ablate_model``, ``ablate_slots`` and ``ablate_gat``) run their plain
versions; the native packer packs a bucket and GIN's
inference stream (``runtime.stream``) runs, sequential and pipelined; the
experiment CLI's ``run`` (GIN, ``--device cpu``) and ``convert`` (an OGB
raw/ directory, gzipped, with eigenvectors) run; the sharded steps of
``parallel`` (``halo_forward`` on all three halo layouts and
``sharded_forward``, two ranks as threads) run all six models, equal to the
single-device forward."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import importlib, pkgutil
import flowgnn_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(flowgnn_tpu_torch.__path__, "flowgnn_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k == "flowgnn_tpu" or k.startswith("flowgnn_tpu.") for k in sys.modules)

import numpy as np
import torch
from flowgnn_tpu_torch.core.graphs import pack_dataset
from flowgnn_tpu_torch.core.numerics import FLOAT32
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_dataset
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders

small = {
    "gin": lambda: loaders.synthetic_gin_params(0, dim=16, hidden=32, layers=2),
    "gcn": lambda: loaders.synthetic_gcn_params(0, dim=16, layers=2),
    "pna": lambda: loaders.synthetic_pna_params(0, dim=16, layers=2),
    "gat": lambda: loaders.synthetic_gat_params(0, dim=16, heads=2, layers=2),
    "dgn": lambda: loaders.synthetic_dgn_params(0, dim=16, layers=2),
}
runs = 0
for name in ("gin", "gin-vn", "gcn", "gat", "pna", "dgn"):
    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=24))
    w, b = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    pack = lambda gs: list(pack_dataset(gs, node_capacity=255, edge_capacity=1536,
                                        graph_capacity=16, with_eigen=spec.needs_eigen,
                                        align_window=w))
    buckets = pack(graphs)
    layouts = [(buckets, base.as_batches_uniform(buckets, blocked="local_slots", window=w), {})]
    layouts.append((buckets, base.as_batches_uniform(buckets, blocked="local_ell", window=w, block=b), {}))
    big = pack(graphs[:4] + registry.apply_transforms(
        spec, [random_molecule_graph(np.random.default_rng(1), num_nodes=200)]))
    spill = base.as_batches_uniform(big, blocked="local_slots", window=w)
    assert any(x["slot_spill_mask"].any() for x in spill)
    layouts.append((big, spill, {}))
    ell_spill = base.as_batches_uniform(big, blocked="local_ell", window=w, block=b)
    assert any(base.ell_spill_lanes(x) for x in ell_spill)
    layouts.append((big, ell_spill, {}))
    blocked = base.as_batches_uniform(big, blocked=True)
    assert all("blk_window" in x for x in blocked)
    layouts.append((big, blocked, {}))
    local = base.as_batches_uniform(big, blocked="local")
    assert any((x["receivers"][x["loc_ulocal"].shape[0]:] < 255).any() for x in local)
    layouts.append((big, local, {}))
    if name == "gin":
        layouts.append((big, blocked, dict(fused=True)))
    if name == "gat":
        layouts.append((big, ell_spill, dict(fuse_layers=True)))
    params = loaders.params_from_numpy(small[name.split("-")[0]](), FLOAT32, "cpu")
    for buckets, batches, kw in layouts:
        for packed, batch in zip(buckets, batches):
            out = spec.forward(params, base.to_device(batch, "cpu"), FLOAT32, **kw)
            assert out.shape == (packed.n_node.shape[0], 1) and bool(out.isfinite().all())
            plain = spec.forward(params, base.to_device(base.as_batch(packed), "cpu"), FLOAT32)
            assert torch.allclose(out[: packed.num_graphs], plain[: packed.num_graphs], atol=1e-5)
    runs += len(layouts)
assert runs == 38, runs
import contextlib, io
from flowgnn_tpu_torch.bench import ablate_gat_mega, matmul_shapes
assert matmul_shapes.measure(8, 64, 128, 2, 2, "int8", reps=1, trials=1, device="cpu") > 0
with contextlib.redirect_stdout(io.StringIO()) as table:
    ablate_gat_mega.main(["--device", "cpu", "--graphs", "24", "--reps", "1", "--trials", "1",
                          "--variants", "full,v3,v4,v5"])
assert len([ln for ln in table.getvalue().splitlines() if not ln.startswith("#")]) == 6, \
    table.getvalue()
from flowgnn_tpu_torch.bench import (ablate_gat, ablate_gat_pairs, ablate_gin_slots,
                                     ablate_model, ablate_slots)
tool = ["--device", "cpu", "--graphs", "6", "--node-cap", "1023", "--reps", "1", "--trials", "1",
        "--dtype", "f32", "--check"]
with contextlib.redirect_stdout(io.StringIO()):
    recs = [ablate_gin_slots.main(tool + ["--variants", "full,nomlp"]),
            ablate_gat_pairs.main(tool + ["--variants", "full,noscore"]),
            ablate_model.main(tool), ablate_slots.main(tool + ["--model", "dgn"]),
            ablate_gat.main(tool)]
assert all(r["metric"].endswith("_per_pass") for r in recs), recs
import json
from flowgnn_tpu_torch.bench import bench
with contextlib.redirect_stdout(io.StringIO()) as rec, contextlib.redirect_stderr(io.StringIO()):
    bench.main(["--device", "cpu", "--model", "gin", "--graphs", "8", "--node-cap", "1023",
                "--trials", "1", "--reps", "1"])
assert json.loads(rec.getvalue().splitlines()[-1])["metric"] == "gin_molhiv_synth_us_per_graph"
from flowgnn_tpu_torch.runtime import native, stream
stream_graphs = synthetic_dataset("molhiv", seed=0, num_graphs=24)
packed, consumed = native.pack_bucket_native(stream_graphs, 1023, 4096, 32, window=128)
assert consumed == 24 and packed.num_graphs == 24
s = stream.InferenceStream("gin", [small["gin"](), small["gin"]()], FLOAT32, node_capacity=255,
                           edge_capacity=1536, graph_capacity=8, device="cpu")
items = [(g, i // 12) for i, g in enumerate(stream_graphs)]
preds = np.array(list(s.run_pipelined(items, workers=2)))
assert preds.shape == (24,) and np.isfinite(preds).all(), preds
assert np.array_equal(preds, np.array(list(s.run(items))))
import tempfile
from flowgnn_tpu_torch import cli
from flowgnn_tpu_torch.core import io as gio, ogb
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stderr(io.StringIO()):
    cli.main(["run", "--model", "gin", "--device", "cpu", "--num-graphs", "8", "--trials", "1",
              "--out", tmp + "/run"])
    assert len(open(tmp + "/run/gin_output.txt").read().splitlines()) == 8
    raw = tmp + "/raw"
    ogb.write_ogb_raw(raw, stream_graphs[:5], np.arange(5.0)[:, None] % 2, gz=True)
    cli.main(["convert", "--raw", raw, "--out", tmp + "/ds", "--eigen"])
    back = list(gio.read_dataset(tmp + "/ds", with_eigen=True))
    assert len(back) == 5 and all(np.array_equal(a.edge_index, b.edge_index)
                                  for a, b in zip(back, stream_graphs))
    assert ogb.load_labels(tmp + "/ds").shape == (5, 1)
from flowgnn_tpu_torch.parallel import halo, inference, multihost
from flowgnn_tpu_torch.parallel import mesh as pmesh
def rank_step(r, store, name, stacked, raw, step):
    m = pmesh.make_mesh(1, 2, rank=r, store=store, log=False)
    p = loaders.params_from_numpy(raw, FLOAT32, "cpu")
    return getattr(inference, step)(registry.get(name).forward, m, FLOAT32)(p, stacked)
for name in ("gin", "gin-vn", "gcn", "gat", "pna", "dgn"):
    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=24))
    packed = next(pack_dataset(graphs, node_capacity=1023, edge_capacity=4096, graph_capacity=32,
                               with_eigen=spec.needs_eigen))
    raw, g = small[name.split("-")[0]](), packed.num_graphs
    plain = spec.forward(loaders.params_from_numpy(raw, FLOAT32, "cpu"),
                         base.to_device(base.as_batch(packed), "cpu"), FLOAT32)
    cases = [(inference.stack_halo_buckets([halo.build_halo_batch(
        packed, k=2, edge_slack=4.0, blocked=blocked)]), "halo_forward")
        for blocked in (None, "local_ell", "local_slots")]
    cases.append((inference.stack_buckets([packed]), "sharded_forward"))
    for stacked, step in cases:
        for out in pmesh.run_threads(rank_step, 2, name, stacked, raw, step):
            assert torch.allclose(out[0, :g], plain[:g], atol=1e-5), (name, step)
assert multihost.shard_stream(list(range(3)), 2) == ([[0, 1], [2, 2]], [2, 1])
assert not any(k == "flowgnn_tpu" or k.startswith("flowgnn_tpu.") for k in sys.modules)
print("ok", len(mods))
"""


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=root, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok "), proc.stdout
    assert int(proc.stdout.split()[1]) >= 24  # every module was walked, bench's too
