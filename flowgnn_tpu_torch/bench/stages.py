"""What the stage-split tools share: ``ablate_gin_slots``, ``ablate_gat_pairs``,
``ablate_model``, ``ablate_slots`` and ``ablate_gat``.

Each tool times a whole-model kernel, or a model's stages, on the synthetic
molhiv buckets its JAX counterpart (``flowgnn_tpu.bench.ablate_*``) times on,
with seeded synthetic weights at the registry's full widths. On the card a
stage's time is its launches captured once in a CUDA graph and replayed
(``bench.timing.graph_ms``: device time, the wrappers' host work left out),
the best of ``--trials`` means of ``--reps`` replays. The JAX tools subtract
a dispatch floor (``protocol.dispatch_floor``, or a ``noop`` row) from a
host clock around a jitted loop; a replay has no such floor, so nothing is
subtracted here. ``--device cpu`` runs the plain versions under a host
clock, for a check of the control flow only: its times are not the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

NODE_CAP, EDGE_CAP, GRAPH_CAP = 32768, 98304, 2048  # the JAX tools' bucket


def add_arguments(ap: argparse.ArgumentParser, reps: int) -> None:
    """The options every stage-split tool takes."""
    ap.add_argument("--graphs", type=int, default=1028)
    ap.add_argument("--node-cap", type=int, default=NODE_CAP,
                    help="a bucket's nodes (the JAX tools' 32768; smaller for tests)")
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--weights", default="synthetic", choices=["synthetic", "reference"],
                    help="seeded synthetic weights, or the reference's binaries from "
                         "--reference-root (the tool prints a skip line where they are missing)")
    ap.add_argument("--reference-root", default=None)
    ap.add_argument("--check", action="store_true",
                    help="hold each knocked-out launch against its plain version once")
    ap.set_defaults(seed=0)  # the synthetic weights' seed (``bench.load_params``)


def precision(args):
    from ..core.numerics import BF16, FLOAT32

    return BF16 if args.dtype == "bf16" else FLOAT32


def load_params(name: str, args, prec, device):
    """``name``'s weights on ``device``, or None (a skip line printed) where
    ``--weights reference`` finds no reference tree."""
    from ..params.loaders import params_from_numpy
    from .bench import load_params as numpy_params

    if args.weights == "reference":
        from ..models import registry

        root = args.reference_root or ""
        path = os.path.join(root, registry.get(name).reference_dir)
        if not root or not os.path.isdir(path):
            print(f"# --weights reference: no {path or 'reference tree'}; skipped")
            return None
    return params_from_numpy(numpy_params(name, args), prec, device)


def molhiv_batches(name: str, graphs: int, layout: str, window: int | None, device,
                   block: int | None = None, edge_capacity: int | None = EDGE_CAP,
                   node_capacity: int = NODE_CAP) -> list:
    """The batches of ``graphs`` synthetic molhiv graphs (seed 0) for model
    ``name`` in ``layout``, packed as the JAX tools pack them (32768 nodes,
    ``edge_capacity`` edges or as many as the graphs need when None, 2048
    graphs a bucket) at ``window`` (None: ``choose_geometry``'s) with the ELL
    ``block`` (None: the geometry's), on ``device``."""
    from ..core.graphs import auto_edge_capacity, pack_dataset
    from ..core.synthetic import synthetic_dataset
    from ..models import base, registry

    spec = registry.get(name)
    gs = registry.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=graphs))
    gw, gb = base.choose_geometry(name, max(g.num_nodes for g in gs))
    window = window or gw
    if block is None:
        block = gb if window == gw else base.choose_geometry(name, window)[1]
    edges = edge_capacity or auto_edge_capacity(gs, node_capacity)
    buckets = list(pack_dataset(gs, node_capacity=node_capacity, edge_capacity=edges,
                                graph_capacity=GRAPH_CAP, align_window=window,
                                with_eigen=spec.needs_eigen))
    return [base.to_device(b, device)
            for b in base.as_batches_uniform(buckets, blocked=layout, window=window, block=block)]


def trial_seconds(fn, device, reps: int, trials: int) -> list[float]:
    """Seconds per call of ``fn`` in each of ``trials`` trials: the mean of
    ``reps`` CUDA-graph replays on the card, of ``reps`` calls under the
    host clock on the CPU (each after a warm-up call)."""
    from .matmul_shapes import best_seconds
    from .timing import graph_ms

    if device.type == "cuda":
        return [graph_ms(fn, reps) / 1e3 for _ in range(trials)]
    return [best_seconds(fn, reps, 1, device) for _ in range(trials)]


def timer(device, reps: int, trials: int):
    """seconds(fn): the best of ``trial_seconds``."""
    return lambda fn: min(trial_seconds(fn, device, reps, trials))


def print_stage(label: str, times: list[float], width: int = 28, graphs: int | None = None):
    """One line of the JAX stage tools: the best ms per pass, then the mean
    over the trials (or µs per graph where ``graphs`` is given)."""
    best = min(times)
    tail = (f"({best / graphs * 1e6:6.3f} us/graph)" if graphs else
            f"(avg {sum(times) / len(times) * 1e3:.3f})")
    print(f"{label:{width}s} {best * 1e3:8.3f} ms/pass {tail}")
    return best


def variant_record(metric: str, results: dict) -> dict:
    """The JAX tools' record: ``full``'s µs per pass as the value, every
    variant's, and ``attrib_<v>_us`` = full − v for the others."""
    full = results.get("full")
    rec = {"metric": metric, "value": full * 1e6 if full is not None else None,
           "unit": "us/pass", "variants_us": {k: v * 1e6 for k, v in results.items()}}
    if full is not None:
        for k, v in results.items():
            if k != "full":
                rec[f"attrib_{k}_us"] = (full - v) * 1e6
    return rec


def stage_record(metric: str, stages: dict, **extra) -> dict:
    """The stage tools' record: each stage's ms per pass by its label."""
    return {"metric": metric, "unit": "ms/pass", "stages_ms": {k: v * 1e3 for k, v in
                                                               stages.items()}, **extra}


def print_record(rec: dict) -> None:
    print(json.dumps(rec))
    sys.stdout.flush()


def check(label: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> float:
    """Raises unless ``got`` (a kernel's) agrees with ``want`` (its plain
    version's) within 1e-4 (float32) or 5e-2 (bfloat16) of ``want``'s
    largest magnitude; returns the largest absolute difference."""
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    if not bool(got.isfinite().all()) or err > tol * scale:
        raise AssertionError(f"{label}: the kernel differs from its plain version by {err:.3e} "
                             f"(scale {scale:.3e}, tolerance {tol} of it)")
    print(f"# check {label}: max |kernel - plain| {err:.3e} of scale {scale:.3e}")
    return err
