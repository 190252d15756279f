"""The port's multi-host tier (``flowgnn_tpu_torch.parallel.multihost``) and
``cli run --multihost``, on the CPU: ``initialize`` a no-op for one process
(and an error for half a cluster's environment), ``shard_stream``'s grouping
against the JAX package's, ``global_mesh``'s layout and its error,
``gather_results`` for one process, the parser's options; and two host
processes of ``python -m flowgnn_tpu_torch.cli run --multihost
--edge-shards 2 --local-data 2`` on 20 graphs at graph-cap 4 (5 buckets: a
padded group), each host's four ranks spawned processes over gloo, every
prediction in submission order against the port's single-process forward;
the mesh's transport rule, ``run_processes`` raising a rank's failure, and
``bench.scaling`` on the CPU."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from flowgnn_tpu.parallel import multihost as jmultihost
from flowgnn_tpu_torch import cli
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
from flowgnn_tpu_torch.core.synthetic import synthetic_molhiv
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.parallel import mesh as pm
from flowgnn_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("FLOWGNN_COORDINATOR", "FLOWGNN_NUM_PROCESSES", "FLOWGNN_PROCESS_ID",
            "MASTER_ADDR", "WORLD_SIZE", "RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_single_process_noop(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    monkeypatch.setenv("FLOWGNN_NUM_PROCESSES", "2")  # no coordinator, no id
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()


def test_shard_stream_grouping_matches_jax():
    groups, real = multihost.shard_stream(list(range(5)), local_data=2)
    # A trailing partial group is padded (its last bucket repeated) and marked.
    assert groups == [[0, 1], [2, 3], [4, 4]] and real == [2, 2, 1]
    for n, d in ((7, 3), (4, 1), (1, 2)):
        assert multihost.shard_stream(list(range(n)), d) == jmultihost.shard_stream(
            list(range(n)), d)


def test_global_mesh_and_gather():
    grid = multihost.global_mesh(edge=2, local_ranks=4, hosts=2)
    assert grid.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]  # each edge pair inside a host
    with pytest.raises(ValueError, match="does not divide"):
        multihost.global_mesh(edge=3, local_ranks=4, hosts=2)
    x = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    assert np.array_equal(multihost.gather_results(x), x)


def test_transport_rule():
    """NCCL only where every rank has a GPU of its own; gloo for CPU ranks
    and for ranks that share a GPU (the one-card case)."""
    assert pm.transport(["cpu", "cpu"])[0] == "gloo"
    assert pm.transport(["cuda:0", "cuda:0"])[0] == "gloo"
    assert pm.transport(["cuda:0", "cpu"])[0] == "gloo"
    assert pm.transport(["cuda:0", "cuda:1"])[0] == "nccl"
    assert pm.transport(["cuda:0"])[0] == "nccl"
    assert [str(d) for d in pm.rank_devices(3, "cpu")] == ["cpu"] * 3


def _failing_rank(rank, store):
    mesh = pm.make_mesh(1, 2, rank=rank, store=store, log=False)
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.edge.index


def test_run_processes_raises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        pm.run_processes(_failing_rank, 2, timeout=120)


def test_cli_parser_multihost_options():
    args = cli.build_parser().parse_args(
        ["run", "--multihost", "--edge-shards", "2", "--local-data", "2"])
    assert args.multihost and (args.edge_shards, args.local_data) == (2, 2)
    with pytest.raises(SystemExit):
        cli.main(["run", "--device", "cpu", "--edge-shards", "2"])  # needs --multihost


def test_cli_multihost_two_processes_all_predictions(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(FLOWGNN_COORDINATOR=f"127.0.0.1:{port}", FLOWGNN_NUM_PROCESSES="2",
               PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "flowgnn_tpu_torch.cli", "run", "--device", "cpu",
           "--model", "gin", "--dataset", "synth", "--num-graphs", "20", "--multihost",
           "--edge-shards", "2", "--local-data", "2", "--node-cap", "255",
           "--edge-cap", "1024", "--graph-cap", "4", "--out", str(tmp_path), "--f32"]
    procs = [subprocess.Popen(cmd, env={**env, "FLOWGNN_PROCESS_ID": str(i)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert '"hosts": 2' in logs[0] and '"buckets": 5' in logs[0]
    lines = (tmp_path / "gin_output.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"g{i}" for i in range(1, 21)]
    got = np.array([float(ln.split(":")[1]) for ln in lines])

    spec = tr.get("gin")
    graphs = tr.apply_transforms(spec, synthetic_molhiv(20, seed=0))
    params = loaders.params_from_numpy(loaders.synthetic_gin_params(0), tn.FLOAT32, "cpu")
    want = []
    for b in pack_dataset(graphs, node_capacity=255,
                          edge_capacity=max(1024, auto_edge_capacity(graphs, 255)),
                          graph_capacity=4):
        out = spec.forward(params, tb.to_device(tb.as_batch(b), "cpu"), tn.FLOAT32)
        want.extend(out[: b.num_graphs, 0].tolist())
    assert len(want) == 20 and np.ptp(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("strategy", ["halo", "psum"])
def test_scaling_bench_on_the_cpu(strategy, capsys):
    """``python -m flowgnn_tpu_torch.bench.scaling`` at k = 1, 2 on both axes,
    its ranks spawned once, on seeded synthetic weights (it reads no
    reference tree): one record a (k, axis), figures finite and positive,
    efficiency 1 at k = 1, no GPU."""
    from flowgnn_tpu_torch.bench import scaling

    scaling.main(["--device", "cpu", "--counts", "1,2", "--axis", "data,edge", "--strategy",
                  strategy, "--graphs-per-device", "8", "--trials", "1"])
    import json

    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [(r["devices"], r["axis"]) for r in recs] == [
        (1, "data"), (1, "edge"), (2, "data"), (2, "edge")]
    for r in recs:
        assert r["finite"] and r["edges_per_s"] > 0 and r["time_s"] > 0
        assert r["gpus"] == 0 and r["shared_card"] is False
        assert r["efficiency"] == 1.0 if r["devices"] == 1 else r["efficiency"] > 0
    edge2 = recs[3]
    assert edge2["strategy"] == strategy and edge2["exchange_bytes_per_layer"] > 0
