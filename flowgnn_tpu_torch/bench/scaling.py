"""Multi-rank scaling benchmark: edges/s at 1..K ranks.

The counterpart of ``flowgnn_tpu.bench.scaling``. Two axes, swept
independently, each rank a spawned process (``parallel.mesh.run_processes``):

  * ``axis="data"``: whole buckets per rank, ``graphs_per_device`` graphs
    each (no communication in the forward; ``sharded_forward`` over a k × 1
    mesh);
  * ``axis="edge"``: one batch split across the ranks of a 1 × k mesh.
    Strategy ``"halo"`` runs the node-shard layout with one boundary-row
    all-to-all a layer (``parallel.halo``, ``halo_forward``), ``"psum"`` the
    replicated-node path, whose sums are completed by all-reduces
    (``sharded_forward``). ``scaling="strong"`` shards one fixed batch,
    ``"weak"`` grows the batch with k. ``blocked`` ("local_ell" /
    "local_slots", halo only) packs window-aligned and adds the per-shard
    graph-local layouts, so each shard runs the model's kernels.

Each record holds the rank count, the axis, the best of ``trials`` step
times (the slowest rank's: a step ends with collectives), edges/s and
``efficiency`` = edges/s ÷ (k × the first record's edges/s a rank), and
the bytes a rank sends a layer (``exchange_bytes_per_layer``: the halo
exchange's, or the psum path's all-reduce of the node array). It never
reads the reference tree: the weights are the synthetic ones of seed 0, in
f32, as the JAX tool runs. ``gpus`` counts the distinct GPUs the ranks ran on: ranks that
share one card (``shared_card``) measure the collectives' and the host's
cost, not scaling, and their ``efficiency`` is no scaling figure. Run:

  python -m flowgnn_tpu_torch.bench.scaling --model gin --axis data,edge --counts 1,2,4
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

STRATEGIES = ("halo", "psum")


def _rank_job(rank: int, store, model: str, device, cases: list, trials: int) -> list:
    """One rank's timings: for each case (mesh shape, strategy, the stacked
    batch) whose mesh holds this rank (its first ranks; None for the
    others) the best of ``trials`` timed steps after a warm one, and the
    predictions of the warm step from rank 0."""
    from ..core.numerics import FLOAT32
    from ..models import registry
    from ..params import loaders
    from ..parallel.inference import halo_forward, sharded_forward
    from ..parallel.mesh import cpu_threads, make_mesh, rank_devices

    world = max(shape[0] * shape[1] for shape, _, _ in cases)
    if torch.device(device).type == "cpu":
        cpu_threads(world)
    spec = registry.get(model)
    raw = getattr(loaders, f"synthetic_{model.split('-')[0]}_params")(0)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    out = []
    for i, (shape, strategy, stacked) in enumerate(cases):
        k = shape[0] * shape[1]
        if rank >= k:
            out.append(None)
            continue
        mesh = make_mesh(*shape, rank=rank, store=store, devices=rank_devices(k, device),
                         name=f"case{i}")
        params = loaders.params_from_numpy(raw, FLOAT32, mesh.device)
        step = (halo_forward if strategy == "halo" else sharded_forward)(spec.forward, mesh)
        pred = step(params, stacked).float().cpu().numpy()  # warm: every geometry built
        best = float("inf")
        for _ in range(trials):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            step(params, stacked)
            sync()
            best = min(best, time.perf_counter() - t0)
        out.append((best, pred if rank == 0 else None))
    return out


def run_scaling(
    model: str = "gin",
    graphs_per_device: int = 128,
    device_counts=(1, 2, 4),
    trials: int = 3,
    caps=(4096, 12288, 256),
    axes=("data",),
    strategy: str = "halo",
    blocked: str | None = None,
    scaling: str = "strong",
    device="cuda",
) -> list[dict]:
    """Records for each rank count of ``device_counts`` and each axis of
    ``axes`` (``flowgnn_tpu/bench/scaling.py:30-175``'s sweep; every case
    runs in one set of max(``device_counts``) rank processes, a case of k
    ranks on the first k), in f32. Raises where the psum path's edge
    capacity does not split into k slices."""
    from ..core.graphs import pack_graphs, pack_graphs_aligned
    from ..core.numerics import FLOAT32
    from ..core.synthetic import synthetic_molhiv
    from ..models import registry
    from ..models.base import ELL_DEFAULT_GEOMETRY
    from ..parallel.halo import (
        build_halo_batch, exchange_bytes_per_layer, exchange_width, halo_shape,
        psum_bytes_per_layer,
    )
    from ..parallel.inference import stack_buckets, stack_halo_buckets
    from ..parallel.mesh import rank_devices, run_processes

    spec = registry.get(model)
    total = graphs_per_device * max(device_counts)
    graphs = registry.apply_transforms(spec, synthetic_molhiv(total, seed=0))
    cases, rows = [], []
    for k in device_counts:
        for axis in axes:
            if axis == "data":
                per = graphs_per_device
                buckets = [pack_graphs(graphs[i * per : (i + 1) * per], node_capacity=caps[0],
                                       edge_capacity=caps[1], graph_capacity=caps[2],
                                       with_eigen=spec.needs_eigen) for i in range(k)]
                cases.append(((k, 1), "psum", stack_buckets(buckets)))
                rows.append(dict(devices=k, axis="data",
                                 edges=sum(int(b.n_edge[:-1].sum()) for b in buckets)))
            elif axis == "edge":
                scale = k if scaling == "weak" else max(device_counts)
                pack_kw = dict(node_capacity=caps[0] * scale // 2,
                               edge_capacity=caps[1] * scale // 2,
                               graph_capacity=caps[2] * scale, with_eigen=spec.needs_eigen)
                sel = graphs[: graphs_per_device * scale]
                if blocked and strategy == "halo":
                    packed = pack_graphs_aligned(sel, window=ELL_DEFAULT_GEOMETRY[0], **pack_kw)
                else:
                    packed = pack_graphs(sel, **pack_kw)
                if strategy == "halo":
                    stacked = stack_halo_buckets([build_halo_batch(
                        packed, k=k, edge_slack=2.0 * k, blocked=blocked)])
                    moved = exchange_bytes_per_layer(
                        halo_shape(packed.node_capacity, packed.edge_capacity, k), model, FLOAT32)
                else:
                    stacked = stack_buckets([packed])
                    # The all-reduces run on f32 accumulators (``ops.segment``).
                    moved = psum_bytes_per_layer(packed.node_capacity, exchange_width(model))
                cases.append(((1, k), strategy, stacked))
                rows.append(dict(devices=k, axis="edge", strategy=strategy, scaling=scaling,
                                 blocked=blocked, exchange_bytes_per_layer=0 if k == 1 else moved,
                                 edges=int(packed.n_edge[:-1].sum())))
            else:
                raise ValueError(f"unknown axis {axis!r}")
    device = torch.device(device)
    per_rank = run_processes(_rank_job, max(device_counts), model, device, cases, trials)
    records = []
    for i, row in enumerate(rows):
        k = row["devices"]
        best = max(r[i][0] for r in per_rank[:k])
        pred = per_rank[0][i][1]
        devices = rank_devices(k, device)
        gpus = len({d.index for d in devices}) if device.type == "cuda" else 0
        edges = row.pop("edges")
        row.update(edges_per_s=edges / best, time_s=best, gpus=gpus,
                   shared_card=gpus > 0 and gpus < k, finite=bool(np.isfinite(pred).all()))
        records.append(row)
    for axis in axes:
        mine = [r for r in records if r["axis"] == axis]
        if mine:
            base = mine[0]["edges_per_s"] / mine[0]["devices"]
            for r in mine:
                r["efficiency"] = r["edges_per_s"] / (r["devices"] * base)
    return records


def main(argv=None) -> None:
    from ..bench.matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gin")
    ap.add_argument("--axis", default="data,edge", help="comma-separated: data, edge")
    ap.add_argument("--strategy", default="halo", choices=STRATEGIES)
    ap.add_argument("--scaling", default="strong", choices=["strong", "weak"])
    ap.add_argument("--blocked", default=None, choices=["local_ell", "local_slots"])
    ap.add_argument("--counts", default="1,2,4", help="comma-separated rank counts")
    ap.add_argument("--graphs-per-device", type=int, default=128)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = tool_device(args.device, file=sys.stderr)
    records = run_scaling(
        args.model, args.graphs_per_device, tuple(int(c) for c in args.counts.split(",")),
        args.trials, axes=tuple(args.axis.split(",")), strategy=args.strategy,
        blocked=args.blocked, scaling=args.scaling, device=device,
    )
    for r in records:
        print(json.dumps({"model": args.model, **r}))


if __name__ == "__main__":
    main()
