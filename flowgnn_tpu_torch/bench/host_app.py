"""Sustained host-application benchmark: the counterpart of
``flowgnn_tpu/bench/host_app.py``.

    python -m flowgnn_tpu_torch.bench.host_app --model gin          # on the card
    python -m flowgnn_tpu_torch.bench.host_app --device cpu --graphs 32 --trials 1   # tests only

The bench entry (``bench.bench``) keeps the packed stream on the card and
times passes over it, the counterpart of the reference's device-side "Kernel
Execution" metric. The reference also loads graphs inside every timed pass
(load_graph's CSR build runs in the kernel on each enqueue,
GIN/src/load_inputs.cc:87-172 called from GIN_compute.cc:66-70), hidden
behind its dataflow. This benchmark measures that end to end: a sustained
stream through ``runtime.stream.InferenceStream`` in which every bucket is
packed on the host (window-aligned pack, the kernel layout, the pinned input
buffer), copied to the card and run from its captured CUDA graph,
sequentially (``run``) and pipelined (``run_pipelined``: ``--workers``
threads pack ahead, up to ``--chain`` buckets a dispatch, ``--depth``
dispatches in flight).

The stream, as the JAX tool builds it: ``--graphs`` molhiv-shaped graphs
(seed 0; DGN's eigenvectors attached once, as they ship precomputed), weight
set ``(i // --flip) % --sets`` for graph i, set k > 0 the first set's float
weights scaled by 1 + 0.01·k, bf16, buckets of ``--node-cap`` node rows and
``--graph-cap`` graphs, the edge capacity from the stream's density. Weights:
``--weights synthetic`` (the default) from ``--seed``, or ``--weights
reference`` from ``--reference-root`` (raises where the binaries are
missing), as the bench entry takes them.

Warm-up, before any timed trial: a pin pass over every bucket (the slot
layouts' stream-wide pins settle, so every bucket shares one signature),
then one sequential run, which captures every (signature, weight set). Each
trial's wall time is the host clock around the whole run, the read-back of
the last prediction included; the best of ``--trials`` counts. ``run`` and
``run_pipelined`` must agree to 1e-5.

stdout: one JSON line with the JAX tool's keys (``metric`` =
``{model}_host_app_sustained_us_per_graph``, ``value`` the pipelined
µs/graph, ``sequential_us_per_graph``, ``pipeline_speedup``, ``buckets``,
``dispatches``, ``dispatch_floor_ms`` from ``bench.protocol.dispatch_floor``
and its share of the pipelined wall, ``dispatch_floor_share``, where the JAX
tool's ``relay_floor_share`` was its relay's) and what the card adds:
``pack_ms_per_bucket``, the mean host time of a bucket's pack in the best
sequential trial, and its share of that trial's wall (``sequential_pack_share``);
``replay_ms_per_bucket``, the mean device time of a bucket by replay of its
captured graph (CUDA events), and the share of the pipelined wall the
device is busy (``device_share``; both null on the CPU). stderr: the card's
name and power limit and a ``#`` summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .bench import BASELINES_US

U50_US = BASELINES_US["molhiv"]  # U50 device-only µs/graph on molhiv


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gin", choices=list(U50_US))
    ap.add_argument("--graphs", type=int, default=16384)
    ap.add_argument("--sets", type=int, default=2,
                    help="weight sets, flipped every --flip graphs (reload_weights analog)")
    ap.add_argument("--flip", type=int, default=8192)
    ap.add_argument("--node-cap", type=int, default=32768)
    ap.add_argument("--graph-cap", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--weights", default="synthetic", choices=["synthetic", "reference"])
    ap.add_argument("--reference-root", default=None,
                    help="--weights reference: the reference tree holding GIN/, GCN/, ...")
    ap.add_argument("--seed", type=int, default=0, help="--weights synthetic: the weights' seed")
    args = ap.parse_args(argv)
    if args.weights == "reference" and not args.reference_root:
        ap.error("--weights reference needs --reference-root")
    return args


def weight_sets(args) -> list[dict]:
    """The stream's weight sets: the model's weights (``bench.load_params``),
    then for k = 1 .. sets − 1 a copy with every float array scaled by
    1 + 0.01·k, so that the flip is real work."""
    import numpy as np

    from .bench import load_params

    params = load_params(args.model, args)
    return [params] + [
        {k: v * (1.0 + 0.01 * i) if np.issubdtype(np.asarray(v).dtype, np.floating) else v
         for k, v in params.items()}
        for i in range(1, args.sets)]


def edge_capacity(graphs, node_capacity: int) -> int:
    """The buckets' edge capacity, as the JAX tool sizes it: the node
    capacity times the stream's edges a node (at least 1) plus 1.5."""
    per_node = sum(g.num_edges for g in graphs) / max(sum(g.num_nodes for g in graphs), 1)
    return int(node_capacity * (max(per_node, 1.0) + 1.5))


def measure(args, device) -> dict:
    """The sustained stream's figures (the record without its metric)."""
    import numpy as np
    import torch

    from ..core.graphs import laplacian_eigenvectors
    from ..core.numerics import BF16
    from ..core.synthetic import synthetic_molhiv
    from ..models import registry
    from ..runtime.stream import InferenceStream
    from .protocol import dispatch_floor

    spec = registry.get(args.model)
    graphs = synthetic_molhiv(args.graphs, seed=0)
    if spec.needs_eigen:
        graphs = [laplacian_eigenvectors(g) for g in graphs]
    stream = InferenceStream(
        args.model, weight_sets(args), BF16, node_capacity=args.node_cap,
        edge_capacity=edge_capacity(graphs, args.node_cap), graph_capacity=args.graph_cap,
        device=device)
    items = [(g, (i // args.flip) % args.sets) for i, g in enumerate(graphs)]

    # Warm-up: the pin pass, then one sequential run, which captures every
    # (signature, weight set) the timed runs replay.
    buckets = list(stream._bucketize(items))
    for bucket, _ in buckets:
        stream._make_batch(bucket)
    list(stream.run(items))

    def timed(fn):
        """(seconds, predictions, pack seconds, dispatches) of the best trial."""
        best = (float("inf"),)
        for _ in range(args.trials):
            t0 = time.perf_counter()
            got = np.array(list(fn()))
            t = time.perf_counter() - t0
            if t < best[0]:
                best = (t, got, list(stream.pack_seconds), stream.last_dispatches)
        return best

    seq_s, seq_out, seq_packs, _ = timed(lambda: stream.run(items))
    pipe_s, pipe_out, _, dispatches = timed(lambda: stream.run_pipelined(
        items, depth=args.depth, chain=args.chain, workers=args.workers))
    if not seq_out.shape[0] == args.graphs == pipe_out.shape[0]:
        raise RuntimeError(f"{args.model}: {seq_out.shape[0]} and {pipe_out.shape[0]} "
                           f"predictions for {args.graphs} graphs")
    np.testing.assert_allclose(seq_out, pipe_out, rtol=1e-5, atol=1e-5)

    replay_ms = None
    if device.type == "cuda":
        keys = stream.last_buckets
        per_key = {key: stream.replay_ms(*key) for key in set(keys)}
        replay_ms = sum(per_key[key] for key in keys) / len(keys)
        torch.cuda.synchronize(device)
    floor = dispatch_floor(BF16, device=device)
    pack_ms = sum(seq_packs) / len(seq_packs) * 1e3
    us = pipe_s / args.graphs * 1e6
    return {
        "value": us,
        "sequential_us_per_graph": seq_s / args.graphs * 1e6,
        "pipeline_speedup": seq_s / pipe_s,
        "buckets": len(buckets),
        "dispatch_floor_ms": floor * 1e3,
        "dispatches": dispatches,
        "dispatch_floor_share": dispatches * floor / pipe_s,
        "pack_ms_per_bucket": pack_ms,
        "sequential_pack_share": sum(seq_packs) / seq_s,
        "replay_ms_per_bucket": replay_ms,
        "device_share": None if replay_ms is None else replay_ms * len(buckets) / 1e3 / pipe_s,
        "captured_graphs": len(stream.captured()),
        "u50_device_only_us": U50_US[args.model],
        "vs_u50_device_only": U50_US[args.model] / us,
        "graphs": args.graphs,
        "workers": args.workers,
        "device": device.type,
        "weights": args.weights,
    }


def main(argv=None) -> int:
    import torch

    from .matmul_shapes import tool_device

    args = parse_args(argv)
    device = tool_device(args.device, file=sys.stderr)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rec = {"metric": f"{args.model}_host_app_sustained_us_per_graph", "unit": "us/graph",
           **measure(args, device)}
    print(json.dumps(rec), flush=True)
    replay = ("replay not measured (CUDA graphs need a card)" if rec["replay_ms_per_bucket"] is None
              else f"replay {rec['replay_ms_per_bucket']:.4f} ms/bucket = device share "
                   f"{rec['device_share'] * 100:.1f}% of the pipelined wall")
    print(f"# {args.model}: sustained pipelined {rec['value']:.3f} us/graph (sequential "
          f"{rec['sequential_us_per_graph']:.3f}, x{rec['pipeline_speedup']:.2f}), "
          f"{rec['buckets']} buckets / {rec['dispatches']} dispatches, pack "
          f"{rec['pack_ms_per_bucket']:.2f} ms/bucket ({rec['sequential_pack_share'] * 100:.1f}% "
          f"of the sequential wall), {replay}, launch floor "
          f"{rec['dispatch_floor_share'] * 100:.2f}% of the wall", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
