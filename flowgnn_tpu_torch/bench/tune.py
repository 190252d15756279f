"""Window / block sweep of the graph-local kernels (``python -m
flowgnn_tpu_torch.cli tune``).

The port's counterpart of ``flowgnn_tpu.bench.tune``: for one model it
sweeps the window W (node rows a cluster of W/128 blocks holds) and, for the
ELL models, the block B (edge lanes a window's block holds) on the card,
times each geometry with the bench entry's protocol
(``bench.protocol.time_stream``: the stream on the card, CUDA events around
``reps`` eager passes a trial after the warm-up, best and mean of
``trials``), and prints a ranked table and the winner in the form of
``GEOMETRY_DEFAULTS`` (``flowgnn_tpu_torch/models/base.py``). The sweep
measures this card; the JAX package's v5e tables are not its defaults.

The layouts are the JAX sweep's: slots for PNA, GAT and DGN (no B axis; W
only, the slot depth sized by the layout, overflowing edges on the spill
tail), ELL for GIN, GIN-VN and GCN with B from the packed stream itself
(``block_candidates``: the least lane count that keeps every window's edges
in one block, k = 1, and one slack step of 128 or 256 lanes). The stream is
packed at caps 32768 / 2048, aligned to each window. The port's kernels take
W = 128..1024 in steps of 128.

A departure from the JAX sweep, which catches every exception per geometry
and goes on: on a card a failed launch leaves a sticky CUDA error, and every
later geometry would then "fail" too. Here only the ``ValueError`` by which
the port's wrappers refuse a geometry before any launch (a window their
clusters cannot span, more shared memory than the card allows) skips the
geometry, with a line on stderr; anything else propagates.
"""

from __future__ import annotations

import sys

import numpy as np


def _window_densities(packed, window: int) -> np.ndarray:
    """Edges per node window (local edges only: both endpoints in-window)."""
    n = packed.node_capacity + 1
    s, r = packed.senders, packed.receivers
    real = r < n - 1
    local = real & (s // window == r // window)
    num_windows = -(-n // window)
    return np.bincount(r[local] // window, minlength=num_windows)


def block_candidates(packed, window: int) -> list[int]:
    """The least multiple of 128 lanes (at least 128) that holds the
    fullest window's local edges, and that plus one slack step (256 lanes
    at W ≥ 256, else 128)."""
    dens = int(_window_densities(packed, window).max())
    b_min = max(128, -(-dens // 128) * 128)
    slack = 256 if window >= 256 else 128
    return [b_min, b_min + slack]


def sweep(
    model: str,
    dataset: str = "molhiv",
    num_graphs: int = 1028,
    windows: tuple[int, ...] = (128, 256, 512),
    reps: int = 50,
    trials: int = 3,
    f32: bool = False,
    weights: str = "synthetic",
    reference: str | None = None,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Time ``model`` over ``num_graphs`` graphs of the synthetic ``dataset``
    profile at each window of ``windows`` (and each derived block); returns
    ``{"model", "dataset", "results"}`` with the records ranked by µs/graph
    (best trial), the mean beside it."""
    import argparse

    import torch

    from ..core.graphs import auto_edge_capacity, pack_dataset
    from ..core.numerics import BF16, FLOAT32
    from ..core.synthetic import synthetic_dataset
    from ..models import registry
    from ..models.base import as_batch, to_device
    from ..params.loaders import params_from_numpy
    from .bench import SLOT_MODELS, geometry, load_params
    from .protocol import time_stream

    device = torch.device(device)
    prec = FLOAT32 if f32 else BF16
    spec = registry.get(model)
    source = argparse.Namespace(weights=weights, reference_root=reference, seed=seed)
    params = params_from_numpy(load_params(model, source), prec, device)
    graphs = registry.apply_transforms(
        spec, synthetic_dataset(dataset, seed=0, num_graphs=num_graphs))
    layout = "local_slots" if model in SLOT_MODELS else "local_ell"
    total = len(graphs)

    results = []
    for w in windows:
        buckets = list(pack_dataset(
            graphs, node_capacity=32768, edge_capacity=auto_edge_capacity(graphs, 32768),
            graph_capacity=2048, with_eigen=spec.needs_eigen, align_window=w))
        blocks = [None] if layout == "local_slots" else block_candidates(buckets[0], w)
        for b in blocks:
            batches = [to_device(as_batch(bk, blocked=layout, window=w, block=b), device)
                       for bk in buckets]
            try:
                best, avg = time_stream(spec, params, batches, prec, reps, trials)
            except ValueError as e:  # a wrapper refused the geometry before any launch
                print(f"# W{w}/B{b}: refused ({e})", file=sys.stderr)
                continue
            us = best / total * 1e6
            results.append({"window": w, "block": b, "us_per_graph": us,
                            "us_per_graph_avg": avg / total * 1e6})
            print(f"# W{w}/B{b}: {us:.2f} us/graph (avg {avg / total * 1e6:.2f})",
                  file=sys.stderr)

    results.sort(key=lambda r: r["us_per_graph"])
    if results:
        top = results[0]
        # A slot model has no B axis; its entry keeps the block scaled to W.
        block = top["block"] or geometry(model, 0, ell_window=top["window"])[1]
        print(f"# best: \"{model}\": ({top['window']}, {block})  # "
              f"{top['us_per_graph']:.2f} us/graph — paste into GEOMETRY_DEFAULTS "
              "(flowgnn_tpu_torch/models/base.py)", file=sys.stderr)
    return {"model": model, "dataset": dataset, "results": results}
