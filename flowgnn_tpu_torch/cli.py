"""The port's experiment CLI — the run_experiments.sh analog.

Usage:
  python -m flowgnn_tpu_torch.cli run [--model all|gin|...] [--dataset synth|molhiv|molpcba|hep10k|DIR]
                                      [--trials N] [--out DIR] [--f32] [--layout plain|blocked|local]
                                      [--trace DIR] [--device cuda|cpu]
                                      [--weights synthetic|reference] [--reference DIR] [--seed S]
  python -m flowgnn_tpu_torch.cli accuracy --model M --dataset DIR [--metric auto|rocauc|ap]
  python -m flowgnn_tpu_torch.cli convert --raw <ogb>/raw --out DIR [--eigen] [--limit N]
  python -m flowgnn_tpu_torch.cli tune --model M [--dataset molhiv] [--windows 128,256,512]

The counterpart of ``flowgnn_tpu.cli`` with its subcommands and options.
For each (model, dataset) case ``run`` follows the protocol of the
reference's run_experiments.sh (:28-49): load the dataset, run the whole stream
through the device ``--trials`` times, report the average time over graphs
as ms per graph, and write into ``--out``:

  <model>_output.txt     per-graph predictions "g%d: %.8f" in submission
                         order (HLS_output.txt format, GIN/src/host.cc:213-222)
  summary.<model>.csv    kernel-execution stats in the shape of the XRT
                         profile summary the reference commits
                         (GIN/summary.molhiv.csv:41), the kernel named
                         ``<model>_compute_graphs``
  results.json           one record per model

``run``, ``accuracy`` and ``tune`` run on the card unless given ``--device
cpu``; without a card they exit non-zero before any work
(``bench.matmul_shapes.tool_device``, which prints ``nvidia-smi``'s name and
power limit on stderr). ``--device cpu`` runs the kernels' plain versions:
for tests, not for figures. ``convert`` runs no model. ``--weights
synthetic`` (the default) draws each model's weights from ``--seed``;
``--weights reference`` loads the reference's binaries from ``--reference``
and raises ``FileNotFoundError`` where a model's directory is missing. Multi-
host (``--multihost``, ``--edge-shards``, ``--local-data`` other than 1)
exits with a parser error: it waits for the port of ``parallel/``.

Stated departures from the JAX CLI:
  * ``run`` warms up with one pass over every bucket, where the JAX CLI runs
    ``batches[0]`` alone (``flowgnn_tpu/cli.py:127``): the port builds and
    plans a kernel at the first launch of each geometry, so a one-bucket
    warm-up would leave a build inside trial 1.
  * ``accuracy`` scores through the stream ``run`` builds (the layout
    policy, so the model's kernel on the card), where the JAX CLI scores
    through the plain edge list (``as_batch(b)``, ``flowgnn_tpu/cli.py:316``),
    which runs no hand-written kernel. The function is the same.
  * ``--node-cap``, ``--edge-cap`` and ``--graph-cap`` set ``run``'s bucket
    capacities; the JAX CLI reads them only with ``--multihost`` and packs
    ``run`` at the same defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MODELS = ("gin", "gin-vn", "gcn", "gat", "pna", "dgn")
CAPS = (8192, 24576, 512)  # node, edge (at least), graph capacity of a bucket
MULTIHOST = "multi-host waits for the port of parallel/ (ROADMAP queue 1, item 11)"


def _load_graphs(dataset: str, spec, num_graphs: int | None):
    """'synth' (molhiv-shaped, 4113 graphs by default), a synthetic profile
    or a reference-layout directory (``core.io.read_dataset``)."""
    from .core import io as gio
    from .core.synthetic import DATASET_PROFILES, synthetic_dataset, synthetic_molhiv

    if dataset == "synth":
        return synthetic_molhiv(num_graphs or 4113, seed=0)
    if dataset in DATASET_PROFILES:
        return synthetic_dataset(dataset, seed=0, num_graphs=num_graphs)
    return list(gio.read_dataset(dataset, num_graphs=num_graphs, with_eigen=spec.needs_eigen))


def _params(name: str, prec, device, weights: str, reference_root, seed: int) -> dict:
    """``name``'s weights on ``device``: seeded synthetic ones or the
    reference's binaries (``bench.bench.load_params``)."""
    from .bench.bench import load_params
    from .params.loaders import params_from_numpy

    if weights == "reference" and not reference_root:
        raise ValueError("--weights reference needs the reference tree (--reference)")
    source = argparse.Namespace(weights=weights, reference_root=reference_root, seed=seed)
    return params_from_numpy(load_params(name, source), prec, device)


def build_stream(name: str, graphs, layout: str | None, caps=CAPS, device="cpu") -> dict:
    """The stream of ``graphs`` (transformed) for ``name``, on ``device``:
    packed at ``caps`` (edges at least ``auto_edge_capacity``) and laid out
    as the bench entry lays out its stream (``bench.bench.pack_stream``; the
    layout policy of ``flowgnn_tpu/cli.py:75-121``), at ``choose_geometry``'s
    window and block. Returns the buckets, the batches on ``device``, the
    layout (``as_batch``'s ``blocked``) and the window (the edge-block
    layout's for ``blocked``, None for the plain edge list)."""
    from .bench.bench import pack_stream
    from .core.graphs import auto_edge_capacity
    from .models.base import PALLAS_WINDOW, choose_geometry, to_device

    layout = layout or "local"
    window, block = choose_geometry(name, max(g.num_nodes for g in graphs))
    s = pack_stream(name, graphs, layout, window, block, caps[0],
                    max(caps[1], auto_edge_capacity(graphs, caps[0])), caps[2])
    return dict(buckets=s["buckets"], batches=[to_device(b, device) for b in s["batches"]],
                layout=s["layout"] if isinstance(s["layout"], str) else layout,
                window={"plain": None, "blocked": PALLAS_WINDOW}.get(layout, window))


def predictions(spec, params: dict, batches: list, prec) -> list:
    """One forward over every bucket, each bucket's predictions read back to
    the host (which waits for the device)."""
    pending = [spec.forward(params, b, prec) for b in batches]
    return [o.float().cpu().numpy() for o in pending]


def run_case(
    name: str,
    dataset: str,
    trials: int,
    out_dir: str,
    prec,
    reference_root: str | None = None,
    num_graphs: int | None = None,
    caps=CAPS,
    layout: str | None = None,
    trace_dir: str | None = None,
    *,
    device="cuda",
    weights: str = "synthetic",
    seed: int = 0,
) -> dict:
    """One (model, dataset) case of ``run`` (``flowgnn_tpu/cli.py:45-168``):
    the stream on ``device`` before any timing, one warm pass over every
    bucket, then ``trials`` trials, each the host clock around the forward
    over every bucket and the readback of every prediction
    (``profiling.KernelStats``), inside ``profiling.trace(trace_dir)``.
    Writes ``<name>_output.txt`` and ``summary.<name>.csv`` into
    ``out_dir``; returns the JAX CLI's record with the layout, window,
    weights and buckets added."""
    import torch

    from .bench.profiling import KernelStats, trace
    from .models import registry

    device = torch.device(device)
    spec = registry.get(name)
    params = _params(name, prec, device, weights, reference_root, seed)
    graphs = registry.apply_transforms(spec, _load_graphs(dataset, spec, num_graphs))
    s = build_stream(name, graphs, layout, caps, device)
    batches, counts = s["batches"], [b.num_graphs for b in s["buckets"]]
    total = sum(counts)

    predictions(spec, params, batches, prec)  # the warm pass: every geometry built
    stats = KernelStats(f"{name}_compute_graphs")
    outs = None
    with trace(trace_dir, device):
        for _ in range(trials):
            with stats.enqueue():
                outs = predictions(spec, params, batches, prec)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_output.txt"), "w") as f:
        g = 1
        for out, k in zip(outs, counts):
            for val in out[:k, 0]:
                f.write(f"g{g}: {float(val):.8f}\n")
                g += 1
    with open(os.path.join(out_dir, f"summary.{name}.csv"), "w") as f:
        f.write(stats.csv())

    avg_ms = sum(stats.times_s) / len(stats.times_s) * 1e3
    return {
        "model": name,
        "dataset": dataset,
        "num_graphs": total,
        "avg_ms": avg_ms,
        "ms_per_graph": avg_ms / total,
        "graphs_per_s": total / (avg_ms / 1e3),
        "layout": s["layout"],
        "window": s["window"],
        "weights": weights,
        "buckets": len(counts),
    }


def accuracy_scores(
    name: str,
    dataset: str,
    prec,
    reference_root: str | None = None,
    num_graphs: int | None = None,
    *,
    device="cuda",
    weights: str = "synthetic",
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(scores [graphs], labels [graphs, tasks]) of a labelled dataset: an
    OGB raw/ directory, or a converted one with ``labels.csv``; raises the
    JAX CLI's ``SystemExit`` with neither. The scores are task 0 of the
    model's forward over the stream ``run`` builds."""
    import torch

    from .core import ogb as ogb_io
    from .models import registry

    device = torch.device(device)
    spec = registry.get(name)
    params = _params(name, prec, device, weights, reference_root, seed)
    if os.path.exists(os.path.join(dataset, "num-node-list.csv")) or \
            os.path.exists(os.path.join(dataset, "num-node-list.csv.gz")):
        graphs, labels = ogb_io.load_ogb_raw(
            dataset, with_eigen=spec.needs_eigen, limit=num_graphs)
    else:
        labels = ogb_io.load_labels(dataset)
        if labels is None:
            raise SystemExit(
                f"{dataset} has no labels.csv — produce one with "
                "`python -m flowgnn_tpu_torch.cli convert`"
            )
        graphs = _load_graphs(dataset, spec, num_graphs)
        labels = labels[: len(graphs)]
    graphs = registry.apply_transforms(spec, graphs)
    s = build_stream(name, graphs, None, CAPS, device)
    outs = predictions(spec, params, s["batches"], prec)
    scores = np.concatenate([o[: b.num_graphs, 0] for o, b in zip(outs, s["buckets"])])
    return scores, labels


def run_accuracy(
    name: str,
    dataset: str,
    prec,
    reference_root: str | None = None,
    num_graphs: int | None = None,
    metric: str = "auto",
    *,
    device="cuda",
    weights: str = "synthetic",
    seed: int = 0,
) -> dict:
    """Score a labelled dataset (``flowgnn_tpu/cli.py:269-337``): task 0 of
    the labels, ``metric`` "auto" meaning AP for multi-task labels and
    ROC-AUC otherwise. Returns the JAX record with ``weights`` added."""
    from .bench.metrics import average_precision, roc_auc

    scores, labels = accuracy_scores(name, dataset, prec, reference_root, num_graphs,
                                     device=device, weights=weights, seed=seed)
    if metric == "auto":
        metric = "ap" if labels.shape[1] > 1 else "rocauc"
    # The reference compiles NUM_TASK=1 (GIN/src/dcl.h) and these weights
    # predict a single output, so multi-task label files (molpcba) are
    # scored on task 0 only.
    if labels.shape[1] > 1:
        print(
            f"note: {labels.shape[1]}-task labels but the model head is "
            "single-task (reference NUM_TASK=1) — scoring task 0",
            file=sys.stderr,
        )
    if weights == "synthetic":
        print("note: synthetic weights — the metric measures no trained model",
              file=sys.stderr)
    value = (
        average_precision(labels[:, 0], scores)
        if metric == "ap"
        else roc_auc(labels[:, 0], scores)
    )
    return {"model": name, "dataset": dataset, "metric": metric,
            "value": float(value), "num_graphs": int(len(scores)), "weights": weights}


def _device_options(p: argparse.ArgumentParser) -> None:
    """The options the port adds to each subcommand that runs a model."""
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu (the kernels' plain versions: tests)")
    p.add_argument("--weights", default="synthetic", choices=["synthetic", "reference"])
    p.add_argument("--reference", default=None,
                   help="--weights reference: the reference tree holding GIN/, GCN/, ...")
    p.add_argument("--seed", type=int, default=0, help="--weights synthetic: the weights' seed")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="flowgnn_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    conv = sub.add_parser(
        "convert", help="OGB raw CSVs -> reference dataset layout + labels"
    )
    conv.add_argument("--raw", required=True, help="OGB dataset raw/ dir")
    conv.add_argument("--out", required=True)
    conv.add_argument("--eigen", action="store_true",
                      help="attach Laplacian eigenvectors (DGN)")
    conv.add_argument("--limit", type=int, default=None)

    acc = sub.add_parser("accuracy", help="score a labelled dataset")
    acc.add_argument("--model", required=True, choices=list(MODELS))
    acc.add_argument("--dataset", required=True,
                     help="reference-layout dir with labels.csv, or OGB raw/")
    acc.add_argument("--metric", default="auto", choices=["auto", "rocauc", "ap"])
    acc.add_argument("--num-graphs", type=int, default=None)
    acc.add_argument("--f32", action="store_true")
    _device_options(acc)

    tune = sub.add_parser("tune", help="sweep the graph-local kernels' window and block")
    tune.add_argument("--model", required=True, choices=list(MODELS))
    tune.add_argument("--dataset", default="molhiv",
                      help="synthetic profile (molhiv|molpcba|hep10k)")
    tune.add_argument("--windows", default="128,256,512",
                      help="comma-separated window sizes to sweep (128..1024, steps of 128)")
    tune.add_argument("--num-graphs", type=int, default=1028)
    tune.add_argument("--reps", type=int, default=50)
    tune.add_argument("--trials", type=int, default=3)
    tune.add_argument("--f32", action="store_true")
    _device_options(tune)

    run = sub.add_parser("run", help="run inference experiments")
    run.add_argument("--model", default="all", choices=["all", *MODELS])
    run.add_argument("--dataset", default="synth",
                     help="'synth', a profile (molhiv|molpcba|hep10k), or a "
                          "reference-layout dataset dir")
    run.add_argument("--pallas", action="store_true", help="alias for --layout blocked")
    run.add_argument("--layout", default=None, choices=["plain", "blocked", "local"],
                     help="edge layout (default: local, the layout policy of the bench entry)")
    run.add_argument("--trace", default=None,
                     help="write a torch.profiler Chrome trace of the trials into this dir")
    run.add_argument("--num-graphs", type=int, default=None)
    run.add_argument("--trials", type=int, default=5)
    run.add_argument("--out", default="results")
    run.add_argument("--f32", action="store_true")
    run.add_argument("--multihost", action="store_true", help=f"not supported: {MULTIHOST}")
    run.add_argument("--edge-shards", type=int, default=1, help=f"1 only: {MULTIHOST}")
    run.add_argument("--local-data", type=int, default=1, help=f"1 only: {MULTIHOST}")
    run.add_argument("--node-cap", type=int, default=CAPS[0])
    run.add_argument("--edge-cap", type=int, default=CAPS[1])
    run.add_argument("--graph-cap", type=int, default=CAPS[2])
    _device_options(run)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.cmd == "convert":
        from .core.ogb import convert_ogb

        n = convert_ogb(args.raw, args.out, with_eigen=args.eigen, limit=args.limit)
        print(f"converted {n} graphs -> {args.out}", file=sys.stderr)
        return
    if args.cmd == "run" and (args.multihost or args.edge_shards != 1 or args.local_data != 1):
        ap.error(f"--multihost, --edge-shards, --local-data: {MULTIHOST}")
    if args.weights == "reference" and not args.reference:
        ap.error("--weights reference needs --reference")

    import torch

    from .bench.matmul_shapes import tool_device
    from .core.numerics import BF16, FLOAT32

    device = tool_device(args.device, file=sys.stderr)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prec = FLOAT32 if args.f32 else BF16
    source = dict(device=device, weights=args.weights, seed=args.seed)

    if args.cmd == "tune":
        from .bench.tune import sweep

        out = sweep(
            args.model, dataset=args.dataset, num_graphs=args.num_graphs,
            windows=tuple(int(w) for w in args.windows.split(",")),
            reps=args.reps, trials=args.trials, f32=args.f32,
            reference=args.reference, **source,
        )
        print(json.dumps(out))
        return
    if args.cmd == "accuracy":
        r = run_accuracy(args.model, args.dataset, prec, args.reference, args.num_graphs,
                         args.metric, **source)
        print(f"{r['model']} {r['metric']} = {r['value']:.4f} "
              f"({r['num_graphs']} graphs)", file=sys.stderr)
        print(json.dumps(r))
        return

    names = list(MODELS) if args.model == "all" else [args.model]
    layout = args.layout or ("blocked" if args.pallas else None)
    results = []
    for name in names:
        r = run_case(
            name, args.dataset, args.trials, args.out, prec, args.reference,
            args.num_graphs, caps=(args.node_cap, args.edge_cap, args.graph_cap),
            layout=layout, trace_dir=args.trace, **source,
        )
        results.append(r)
        print(
            f"{name} on {args.dataset}: {r['ms_per_graph'] * 1e3:.2f} us/graph "
            f"({r['graphs_per_s']:.0f} graphs/s)",
            file=sys.stderr,
        )
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
