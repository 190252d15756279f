"""The port's bench entry: the counterpart of the root ``bench.py``.

    python -m flowgnn_tpu_torch.bench.bench                     # all six models on molhiv, on the card
    python -m flowgnn_tpu_torch.bench.bench --dataset hep10k --model gin
    python -m flowgnn_tpu_torch.bench.bench --device cpu --model gin --graphs 32 --trials 1 --reps 1

Headline metric, as ``bench.py`` defines it: the device time per graph over
the whole synthetic stream of a dataset profile (4113 molhiv-shaped graphs,
a 6144-graph molpcba sample, a 2048-graph hep10k sample), bf16 unless
``--f32``, and ``vs_baseline``, the FlowGNN U50's µs/graph over ours
(BASELINE.md). The stream, the window, the layout policy (slots where the
stream fits the window, and for PNA, GAT and DGN always; ELL for a GIN,
GIN-VN or GCN slot stream that spills) and the records are ``bench.py``'s,
through the port's host layer and its geometry (``models.base.
choose_geometry``; GIN-VN and GAT at W=128 where the JAX package puts them at
256 and 384). The timing protocol is ``bench.protocol``'s: batches on the
card first, CUDA events around ``--reps`` eager passes a trial after at
least 0.5 s of warm-up, best and mean of ``--trials``.

stdout holds one JSON record per model with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline``) and ``detail``: the rest of
``bench.py``'s figures (the mean, graphs and edges a second, the buckets,
the roofline fraction and TFLOP/s of ``bench.roofline.report`` on the H100,
the launch floor and its share, the message stage's time and roofline
fraction from ``bench.spmm_stage``) and what the card adds: the stream
replayed from one CUDA graph (``graph_us_per_graph``, the median replay; on
the CPU null, as CUDA graphs need a card), its share of the eager pass
(``device_share``), the stream's host-to-device copy (``h2d_ms``), the SM
clock right after the trials (``sm_clock_mhz``, ``nvidia-smi``), the window,
the layout and the weights. With more than one model the last line is the
geometric-mean speedup over the U50 with each model's figures. stderr
carries the card's name and power limit and one ``#`` line per model.

Weights: ``--weights synthetic`` (the default) draws each model's weights
from ``--seed`` (``params.loaders.synthetic_*_params``); ``--weights
reference`` loads the reference's binaries from ``--reference-root`` and
raises where they are missing. Without a card the entry exits non-zero
unless given ``--device cpu``, which runs the kernels' plain versions: for
tests, not for figures.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

# U50 per-graph latency baselines (BASELINE.md; bench.py:92-99): molhiv's
# counts are the repository's (4113), molpcba's the official OGB graph count
# (43793) and hep10k's its 10000, over the committed total kernel ms.
BASELINES_US = {
    "molhiv": {"gin": 49.5, "gin-vn": 56.2, "gcn": 41.9, "gat": 17.6, "pna": 57.4, "dgn": 32.9},
    "molpcba": {"gin": 51.4, "gin-vn": 58.6, "gcn": 44.0, "gat": 18.2, "pna": 59.9, "dgn": 34.5},
    "hep10k": {"gin": 179.9, "gin-vn": 207.6, "gcn": 163.9, "gat": 54.4, "pna": 157.8,
               "dgn": 138.2},
}
# Default stream lengths (bench.py:125-127): molhiv's official count, and a
# sample of the same synthetic distribution for molpcba and hep10k.
DEFAULT_GRAPHS = {"molhiv": 4113, "molpcba": 6144, "hep10k": 2048}
LAYOUTS = ("plain", "blocked", "local", "local-ell", "local-slots")
LOCAL_LAYOUTS = ("local", "local-ell", "local-slots")
SLOT_MODELS = ("pna", "gat", "dgn")  # slots at any window (bench.py:192)
ELL_FALLBACK = ("gin", "gcn", "gin-vn")  # ELL when their slot stream spills


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="all", help="gin|gin-vn|gcn|gat|pna|dgn|all")
    ap.add_argument("--dataset", default="molhiv", choices=list(BASELINES_US),
                    help="synthetic dataset profile")
    ap.add_argument("--graphs", type=int, default=None, help="override graph count")
    ap.add_argument("--trials", type=int, default=5, help="timed trials; best and mean reported")
    ap.add_argument("--reps", type=int, default=20,
                    help="stream passes per trial (bench.py runs 400 inside one program to "
                         "amortise its relay's round trip; here each pass is timed on the "
                         "card's own stream, and 20 passes give the trial's one wait a "
                         "share of a few percent at most)")
    ap.add_argument("--ell-window", type=int, default=None,
                    help="override the graph-local kernel window")
    ap.add_argument("--ell-block", type=int, default=None,
                    help="override the ELL block (lanes per window's edge block)")
    ap.add_argument("--ell-wps", type=int, default=None,
                    help="windows per ELL grid step: the port's kernels take one window a "
                         "block, so only 1 is accepted")
    ap.add_argument("--f32", action="store_true", help="float32 (default bf16)")
    ap.add_argument("--layout", default=None, choices=list(LAYOUTS),
                    help="edge layout: plain edge list, edge-block windowed scatter, or the "
                         "graph-local kernels (default; local-ell / local-slots force one "
                         "flavour)")
    ap.add_argument("--node-cap", type=int, default=32768)
    ap.add_argument("--edge-cap", type=int, default=None,
                    help="bucket edge capacity (default: from the stream's edge density, "
                         "core.graphs.auto_edge_capacity)")
    ap.add_argument("--graph-cap", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--weights", default="synthetic", choices=["synthetic", "reference"])
    ap.add_argument("--reference-root", default=None,
                    help="--weights reference: the reference tree holding GIN/, GCN/, ...")
    ap.add_argument("--seed", type=int, default=0, help="--weights synthetic: the weights' seed")
    args = ap.parse_args(argv)
    if args.ell_wps not in (None, 1):
        ap.error("--ell-wps: the port's kernels take one window a block (1 only)")
    if args.weights == "reference" and not args.reference_root:
        ap.error("--weights reference needs --reference-root")
    if args.model != "all" and args.model not in BASELINES_US[args.dataset]:
        ap.error(f"--model {args.model}: not one of {', '.join(BASELINES_US[args.dataset])}")
    return args


def geometry(name: str, max_nodes: int, ell_window=None, ell_block=None) -> tuple[int, int]:
    """(window, block) as ``bench.py:144-160`` picks them: ``choose_geometry``'s
    unless overridden; an overridden window without a block gets the block
    scaled to it from the model's default geometry, so that one block still
    holds a window's edges."""
    from ..models.base import ELL_DEFAULT_GEOMETRY, GEOMETRY_DEFAULTS, choose_geometry

    auto_w, auto_b = choose_geometry(name, max_nodes)
    window = ell_window or auto_w
    if ell_window and not ell_block:
        gw, gb = GEOMETRY_DEFAULTS.get(name, ELL_DEFAULT_GEOMETRY)
        block = auto_b if window == auto_w else -(-(gb * window) // (gw * 128)) * 128
    else:
        block = ell_block or auto_b
    return window, block


def stream(name: str, args) -> dict:
    """The host half of ``name``'s stream (``bench.py:125-209``): the
    transformed synthetic graphs of ``args.dataset``, through
    ``pack_stream`` at ``args``' window, block, layout and capacities."""
    from ..core.graphs import auto_edge_capacity
    from ..core.synthetic import synthetic_dataset
    from ..models import registry

    spec = registry.get(name)
    num_graphs = args.graphs if args.graphs is not None else DEFAULT_GRAPHS[args.dataset]
    graphs = registry.apply_transforms(
        spec, synthetic_dataset(args.dataset, seed=0, num_graphs=num_graphs))
    window, block = geometry(name, max(g.num_nodes for g in graphs), args.ell_window,
                             args.ell_block)
    return pack_stream(name, graphs, args.layout or "local", window, block, args.node_cap,
                       args.edge_cap or auto_edge_capacity(graphs, args.node_cap), args.graph_cap)


def pack_stream(name: str, graphs, layout: str, window: int, block: int, node_cap: int,
                edge_cap: int, graph_cap: int) -> dict:
    """``graphs`` (transformed) packed at the capacities (window-aligned for
    the local layouts) and laid out by the layout policy (``bench.py:180-
    209``, the JAX CLI's too): slots where the stream fits the window, and
    for PNA, GAT and DGN always; ELL for a GIN, GIN-VN or GCN stream that
    does not fit, or whose slot stream spills. Returns the buckets, the
    numpy batches, the window, the block and the layout (``as_batch``'s
    ``blocked``)."""
    from ..core.graphs import pack_dataset
    from ..models import registry
    from ..models.base import as_batches_uniform

    spec = registry.get(name)
    buckets = list(pack_dataset(
        graphs, node_capacity=node_cap, edge_capacity=edge_cap, graph_capacity=graph_cap,
        with_eigen=spec.needs_eigen, align_window=window if layout in LOCAL_LAYOUTS else None))
    slot_fits = max(g.num_nodes for g in graphs) <= window
    blocked = {
        "plain": False, "blocked": True, "local-ell": "local_ell", "local-slots": "local_slots",
        "local": "local_slots" if (name in SLOT_MODELS or slot_fits) else "local_ell",
    }[layout]
    batches = as_batches_uniform(buckets, blocked=blocked, window=window, block=block)
    if (layout == "local" and blocked == "local_slots" and name in ELL_FALLBACK
            and any(b["slot_spill"].shape[-1] > 0 for b in batches)):
        blocked = "local_ell"
        batches = as_batches_uniform(buckets, blocked=blocked, window=window, block=block)
    return dict(buckets=buckets, batches=batches, window=window, block=block, layout=blocked)


def load_params(name: str, args) -> dict:
    """``name``'s weights as numpy arrays: seeded synthetic ones, or the
    reference's binaries (raises where they are missing)."""
    from ..models import registry
    from ..params import loaders

    if args.weights == "synthetic":
        return getattr(loaders, f"synthetic_{name.split('-')[0]}_params")(args.seed)
    spec = registry.get(name)
    path = os.path.join(args.reference_root, spec.reference_dir)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"--weights reference: no {path}")
    return spec.loader(path)


def sm_clock_mhz(device) -> float | None:
    """The card's SM clock in MHz as ``nvidia-smi`` reads it now; None on
    the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                          "-i", str(device.index)], capture_output=True, text=True, check=True)
    return float(out.stdout.strip())


def graph_replay_s(one_pass, name: str, layout: str, reps: int) -> float:
    """The median device seconds of one pass replayed from a CUDA graph
    (``timing.replay_ms``); raises, naming the model and the layout, where
    the pass cannot be captured."""
    import statistics

    from .timing import replay_ms

    try:
        return statistics.median(replay_ms(one_pass, max(reps, 3))) / 1e3
    except RuntimeError as exc:
        raise RuntimeError(f"{name} {layout}: its forward cannot be captured in a CUDA graph: "
                           f"{exc}") from exc


def measure(name: str, args, device) -> dict:
    """One model's figures over its stream (``bench.py:103-282``)."""
    import time

    import torch

    from ..core.numerics import BF16, FLOAT32
    from ..models import registry
    from ..models.base import to_device
    from ..params.loaders import params_from_numpy
    from .protocol import dispatch_floor, stream_pass, time_stream, wait
    from .roofline import report
    from .spmm_stage import measure_slot_stage, measure_spmm_stage

    prec = FLOAT32 if args.f32 else BF16
    spec = registry.get(name)
    s = stream(name, args)
    buckets, layout = s["buckets"], s["layout"]
    params = params_from_numpy(load_params(name, args), prec, device)
    wait(device)
    t0 = time.perf_counter()
    batches = [to_device(b, device) for b in s["batches"]]
    wait(device)
    h2d = time.perf_counter() - t0
    total_graphs = sum(b.num_graphs for b in buckets)
    total_edges = sum(int(b.n_edge[:-1].sum()) for b in buckets)
    total_nodes = sum(int(b.n_node[:-1].sum()) for b in buckets)
    baseline = BASELINES_US[args.dataset][name]

    best, avg = time_stream(spec, params, batches, prec, args.reps, args.trials)
    clock = sm_clock_mhz(device)
    graph_s = None
    if device.type == "cuda":
        graph_s = graph_replay_s(stream_pass(spec, params, batches, prec), name, layout, args.reps)
    roof = report(name, total_nodes, total_edges, best, bf16=not args.f32)
    floor = dispatch_floor(prec, device=device)
    spmm = {}
    if "loc_ell" in batches[0]:
        spmm = measure_spmm_stage(batches, prec, reps=args.reps, trials=args.trials,
                                  bf16=not args.f32)
    elif "slot_src" in batches[0]:
        spmm = measure_slot_stage(batches, prec, reps=args.reps, trials=args.trials,
                                  bf16=not args.f32)
    us = best / total_graphs * 1e6
    per_graph = lambda sec: None if sec is None else sec / total_graphs * 1e6
    detail = {
        "us_per_graph_avg": per_graph(avg),
        "graphs_per_s": total_graphs / best,
        "edges_per_s": total_edges / best,
        "buckets": len(buckets),
        "roofline_frac": roof["roofline_frac"],
        "achieved_tflops": roof["achieved_tflops"],
        "dispatch_floor_ms": floor * 1e3,
        "dispatch_share": floor / args.reps / best,
        **{f"spmm_{k}": v for k, v in spmm.items() if k in ("time_us", "roofline_frac")},
        "graph_us_per_graph": per_graph(graph_s),
        "device_share": None if graph_s is None else graph_s / best,
        "h2d_ms": h2d * 1e3,
        "sm_clock_mhz": clock,
        "window": s["window"],
        "layout": layout if isinstance(layout, str) else ("blocked" if layout else "plain"),
        "weights": args.weights,
    }
    return {"us_per_graph": us, "vs_baseline": baseline / us,
            "vs_baseline_avg": baseline / detail["us_per_graph_avg"], "graphs": total_graphs,
            "detail": detail}


def detail_line(name: str, r: dict) -> str:
    """The ``#`` line of one model (``bench.py:293-306``), with the card's
    figures."""
    d = r["detail"]
    spmm = (f", stage {d['spmm_time_us']:.1f} us = {d['spmm_roofline_frac'] * 100:.1f}% of its "
            f"roofline" if "spmm_time_us" in d else "")
    graph = ("graph replay not measured (CUDA graphs need a card)"
             if d["graph_us_per_graph"] is None else
             f"graph replay {d['graph_us_per_graph']:.3f} us/graph = device share "
             f"{d['device_share'] * 100:.1f}%")
    clock = "" if d["sm_clock_mhz"] is None else f", SM clock {d['sm_clock_mhz']:.0f} MHz"
    return (f"# {name}: {r['us_per_graph']:.3f} us/graph best (avg {d['us_per_graph_avg']:.3f}, "
            f"{d['graphs_per_s']:.0f} graphs/s, {d['edges_per_s'] / 1e6:.2f}M edges/s, "
            f"{r['vs_baseline']:.2f}x U50 best / {r['vs_baseline_avg']:.2f}x avg, model "
            f"{d['roofline_frac'] * 100:.1f}% of light speed, {d['achieved_tflops']:.2f} TF/s, "
            f"launch floor {d['dispatch_floor_ms']:.4f} ms = {d['dispatch_share'] * 100:.2f}%/pass"
            f"{spmm}; {graph}; h2d {d['h2d_ms']:.1f} ms{clock}; {r['graphs']} graphs in "
            f"{d['buckets']} buckets, {d['layout']} W={d['window']}, {d['weights']} weights)")


def main(argv=None) -> int:
    import torch

    from .matmul_shapes import tool_device

    args = parse_args(argv)
    device = tool_device(args.device, file=sys.stderr)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    names = list(BASELINES_US[args.dataset]) if args.model == "all" else [args.model]
    results = {}
    for name in names:
        results[name] = measure(name, args, device)
        print(detail_line(name, results[name]), file=sys.stderr, flush=True)
    for name in names:
        r = results[name]
        print(json.dumps({
            "metric": f"{name}_{args.dataset}_synth_us_per_graph",
            "value": round(r["us_per_graph"], 3), "unit": "us/graph",
            "vs_baseline": round(r["vs_baseline"], 3), "detail": r["detail"],
        }))
    if len(names) > 1:
        gm = math.exp(sum(math.log(results[m]["vs_baseline"]) for m in names) / len(names))
        print(json.dumps({
            "metric": f"all_{args.dataset}_synth_geomean_speedup", "value": round(gm, 3),
            "unit": "x_vs_u50", "vs_baseline": round(gm, 3),
            "models": {m: {"us_per_graph": round(results[m]["us_per_graph"], 3),
                           "vs_baseline": round(results[m]["vs_baseline"], 3),
                           "graph_us_per_graph": results[m]["detail"]["graph_us_per_graph"],
                           "device_share": results[m]["detail"]["device_share"]}
                       for m in names},
        }))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
