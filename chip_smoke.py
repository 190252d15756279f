"""Smoke run of the PyTorch / CUDA port (flowgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --profile  # profile the spill path

``--profile`` runs no phase: it builds the hep10k W=128 streams of PNA, DGN
and GAT, warms each path up, traces ``PROFILE_PASSES`` bf16 passes over the
whole stream with ``torch.profiler`` and prints per path the wall time and the
device's busy time per pass (the sum of the device kernels' own times; one
stream, so they do not overlap), the idle share 1 − busy / wall, the kernel
launches per pass, the largest device items and the host operators with the
most CPU time. The profiler adds host time, so the wall times and idle
shares are upper bounds.

Phases, each of which raises (non-zero exit) on failure:

1. the device and ``nvidia-smi``'s name and power limit;
2. the eleven hand-written kernels built from ``flowgnn_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together (build time and each
   compiler's register / shared-memory report);
3. each slot kernel against its plain torch version on the card, at the
   main path's shapes (a real bucket's slot layout at full width: GIN D=100,
   H=200, L=5, with and without the analytic-VN column; GCN D=100, L=5;
   PNA D=80, L=4, T=40; DGN D=100, L=4, T=50; GAT 4 heads × 16, L=5, T=1)
   with seeded random operands: f32 at rtol = atol = 1e-4 (summation order
   only), bf16 at 5e-2 (tolerances as in ``agree``);
3b. each ELL kernel (GIN with and without the VN column, GCN, full width)
   against its plain version the same way, on ELL buckets at W=128 (molhiv),
   W=256 and W=384 (synthetic, one large graph each) and W=512 (the hep10k
   bucket holding its largest graph, ≥ 385 nodes);
3c. each per-layer slot kernel (PNA's ``pna_local_stats_ell``, DGN's
   ``dgn_local_layer_slots``, GAT's ``gat_local_message_slots``) and the
   spill scatter ``windowed_segment_sum`` against its plain version on
   layer 0's operands of the hep10k W=128 bucket with the longest spill
   tail, f32 and bf16;
4. the main path: GIN, GIN-VN, GCN, PNA, DGN and GAT, each over the
   4113-graph synthetic molhiv stream at full width with seeded synthetic
   weights, f32 and bf16, through ``registry`` → ``pack_dataset`` →
   ``as_batches_uniform(local_slots)`` → ``registry.get(name).forward``.
   Every kernel's launch count is set to 0 just before each run and read
   just after: each bucket must have launched its path's kernels (the
   model's whole-model kernel once, or its per-layer kernels once per
   layer) and no other kernel at all. Each bucket's predictions must match
   the port's plain edge-list path in f32 on the card (f32 1e-4, bf16 5e-2,
   see ``run_main_path``);
4b. the ELL path: GIN, GIN-VN and GCN over the 2048-graph synthetic hep10k
   stream at W=512 (``as_batches_uniform(local_ell)``, k=1, no spill), f32
   and bf16, counted and checked as in phase 4; then over the molhiv stream
   at W=128, whose predictions must match the slot path's (f32 1e-4);
4c. the spill path: PNA, DGN and GAT over the same hep10k sample at W=128
   (``as_batches_uniform(local_slots, window=128)``, the JAX bench's
   ``--ell-window 128``), whose window-crossing edges ride the spill tail:
   per layer the model's per-layer slot kernel and the spill scatter,
   counted and checked as in phase 4;
5. CUDA-event timings after warm-up, per model and dtype: µs/graph over the
   whole stream for the kernel path and for the plain edge-list path, and
   each kernel alone against its plain version on the same operands (a
   per-layer kernel on each bucket's layer-0 operands, once per layer), with
   its bound (the larger of its FLOPs over the card's peak for the dtype and
   its bytes over the memory rate) and, for the spill scatter, PyTorch's
   ``index_add_`` of the same values;
5b. the same for the hep10k ELL path, the molhiv stream through the ELL
   kernels at W=128, and the hep10k spill path.

No phase runs at a cut depth: the whole run takes about two minutes on an
H100. The line before the last is a JSON object with one record per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside the repository, it exits non-zero before printing
either.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SEED = 0
NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
STREAM_GRAPHS = 4113  # molhiv's graph count
HEP_GRAPHS = 2048  # the JAX bench's default hep10k sample (bench.py)
SPILL_WINDOW = 128  # the JAX bench's --ell-window 128 on hep10k
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
ELL_MODELS = ("gin", "gin-vn", "gcn")
SPILL_MODELS = ("pna", "dgn", "gat")
SLOTS, ELL = "local_slots", "local_ell"
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 on the tensor cores,
# float32 outside them, and the HBM3 rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
# Each model's kernels: its whole-model slot kernel, its whole-model ELL
# kernel, its per-layer slot kernel (a slot batch with a spill tail).
MODEL_KERNELS = {
    "gin": ("gin_local_model_slots", "gin_local_model", None),
    "gin-vn": ("gin_local_model_slots", "gin_local_model", None),
    "gcn": ("gcn_local_model_slots", "gcn_local_model", None),
    "pna": ("pna_local_model", None, "pna_local_stats_ell"),
    "dgn": ("dgn_local_model", None, "dgn_local_layer_slots"),
    "gat": ("gat_local_model_slots", None, "gat_local_message_slots"),
}
SCATTER = "windowed_segment_sum"  # the spill tail's, beside every per-layer kernel
PROFILE_PASSES = 3  # traced passes per path (--profile)
PER_LAYER = {"pna_local_stats_ell", "dgn_local_layer_slots", "gat_local_message_slots", SCATTER}
LL = "flowgnn_tpu/ops/pallas/local_layer.py"
# Kernel → (its module in flowgnn_tpu_torch.ops, source, the TPU kernel it
# replaces, the (model, profile, layout) path whose bf16 stream gives the
# record's times and bound).
KERNELS = {
    "gin_local_model_slots": ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_model_slots.cu",
                              f"{LL}:944", ("gin", "molhiv", SLOTS)),
    "gcn_local_model_slots": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_model_slots.cu",
                              f"{LL}:1178", ("gcn", "molhiv", SLOTS)),
    "pna_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/pna_local_model.cu",
                        f"{LL}:2062", ("pna", "molhiv", SLOTS)),
    "dgn_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_model.cu",
                        f"{LL}:3104", ("dgn", "molhiv", SLOTS)),
    # One kernel for the three GAT megakernels, which compute one function.
    "gat_local_model_slots": (
        "local_layer", "flowgnn_tpu_torch/csrc/gat_local_model_slots.cu",
        f"{LL}:2567 (gat_local_model_pairs), :2350 (gat_local_model_slots), "
        ":2835 (gat_local_model_dense)", ("gat", "molhiv", SLOTS),
    ),
    "gin_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/gin_local_model.cu",
                        f"{LL}:576", ("gin", "hep10k", ELL)),
    "gcn_local_model": ("local_layer", "flowgnn_tpu_torch/csrc/gcn_local_model.cu",
                        f"{LL}:767", ("gcn", "hep10k", ELL)),
    "pna_local_stats_ell": ("local_layer", "flowgnn_tpu_torch/csrc/pna_local_stats_slots.cu",
                            f"{LL}:1898", ("pna", "hep10k", SLOTS)),
    "dgn_local_layer_slots": ("local_layer", "flowgnn_tpu_torch/csrc/dgn_local_layer_slots.cu",
                              f"{LL}:3000", ("dgn", "hep10k", SLOTS)),
    "gat_local_message_slots": ("local_layer",
                                "flowgnn_tpu_torch/csrc/gat_local_message_slots.cu",
                                f"{LL}:2250", ("gat", "hep10k", SLOTS)),
    SCATTER: ("spmm", "flowgnn_tpu_torch/csrc/windowed_segment_sum.cu",
              "flowgnn_tpu/ops/pallas/spmm.py:62", ("pna", "hep10k", SLOTS)),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_fn(kname: str, plain: bool = False):
    """A kernel's wrapper, or its plain version."""
    import importlib

    mod = importlib.import_module(f"flowgnn_tpu_torch.ops.{KERNELS[kname][0]}")
    return getattr(mod, f"{kname}_ref" if plain else kname)


def model_module(name: str):
    from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna

    return {"gin": gin, "gin-vn": gin, "gcn": gcn, "pna": pna, "dgn": dgn, "gat": gat}[name]


def num_layers(name: str) -> int:
    from flowgnn_tpu_torch.models import registry

    return registry.get(name).num_layers


def bucket_launches(name: str, batch: dict) -> dict:
    """The launches one bucket's forward must make, by kernel: the model's
    whole-model ELL or slot kernel once, or, for a slot batch with a spill
    tail, its per-layer slot kernel and the spill scatter once per layer."""
    slot, ell, layer = MODEL_KERNELS[name]
    if "loc_ell" in batch:
        return {ell: 1}
    if not batch["slot_spill"].shape[-1]:
        return {slot: 1}
    return {layer: num_layers(name), SCATTER: num_layers(name)}


def kernel_calls(kname: str, name: str, params: dict, batches: list, prec) -> list:
    """The keyword operands of every launch of ``kname`` over a stream: a
    whole-model kernel's per bucket, a per-layer kernel's layer-0 operands
    per bucket, repeated once per layer."""
    mod = model_module(name)
    if kname in PER_LAYER:
        ops = [mod.layer_kernel_operands(params, b, prec)[kname] for b in batches]
        return [o for o in ops for _ in range(num_layers(name))]
    return [(mod.ell_kernel_operands if "loc_ell" in b else mod.slot_kernel_operands)(
        params, b, prec) for b in batches]


def synthetic_params(name: str, seed: int) -> dict:
    from flowgnn_tpu_torch.params import loaders

    return {
        "gin": loaders.synthetic_gin_params, "gin-vn": loaders.synthetic_gin_params,
        "gcn": loaders.synthetic_gcn_params, "pna": loaders.synthetic_pna_params,
        "dgn": loaders.synthetic_dgn_params, "gat": loaders.synthetic_gat_params,
    }[name](seed)


def make_stream(name: str, profile: str, num_graphs: int, layout: str, device,
                window: int | None = None):
    """The main path's host half for one model: (packed buckets, kernel
    batches in ``layout``, plain batches), the batches on ``device``. The
    window is ``choose_geometry``'s unless given."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    graphs = registry.apply_transforms(
        spec, synthetic_dataset(profile, seed=SEED, num_graphs=num_graphs)
    )
    gw, block = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    window = window or gw
    buckets = list(pack_dataset(
        graphs, node_capacity=NODE_CAP,
        edge_capacity=auto_edge_capacity(graphs, NODE_CAP),
        graph_capacity=GRAPH_CAP, with_eigen=spec.needs_eigen, align_window=window,
    ))
    batches = base.as_batches_uniform(buckets, blocked=layout, window=window, block=block)
    return (
        buckets,
        [base.to_device(b, device) for b in batches],
        [base.to_device(base.as_batch(b), device) for b in buckets],
    )


def big_graph_bucket(name: str, big: int, device) -> dict:
    """One ELL bucket of 200 molhiv-shaped graphs and four of ``big`` nodes
    at the window ``choose_geometry`` gives them, on ``device``."""
    import numpy as np

    from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
    from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    rng = np.random.default_rng(SEED + big)
    graphs = registry.apply_transforms(registry.get(name), (
        synthetic_dataset("molhiv", seed=SEED, num_graphs=200)
        + [random_molecule_graph(rng, num_nodes=big) for _ in range(4)]
    ))
    window, block = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    packed = pack_graphs_aligned(graphs, node_capacity=8191, edge_capacity=32768,
                                 graph_capacity=256, window=window)
    return base.to_device(base.as_batch(packed, blocked=ELL, window=window, block=block), device)


def gin_random_operands(batch: dict, vn: bool, dtype, device, seed: int) -> dict:
    """GIN kernel operands at full width on a real bucket's slot or ELL
    layout, with seeded random h0 and weights."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import base

    L, D, H = 5, 100, 200
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32)).to(device, dtype)
    n = batch["node_feat"].shape[0]
    ops = dict(
        h0=t(n, D), pool_gl=batch["pool_gl"],
        ee_tables=t(L * 13, D), w1_all=t(L * H, D), b1_all=t(L, H),
        w2_all=t(L * D, H), b2_all=t(L, D),
        eps_all=(1 + t(L, 1)).float(), pred_w=t(D, 1), num_layers=L,
        gmax=base.POOL_GMAX, vn_col=batch["vn_mask"].to(dtype) if vn else None,
    )
    if "loc_ell" in batch:
        return dict(ops, ell_meta=base.ell_meta(batch), window=base.ell_geometry(batch)[0])
    slots = batch["slot_geom"].shape[-1]
    return dict(
        ops, slot_meta=batch["slot_meta"], window=batch["slot_geom"].shape[0], slots=slots,
        prefix_caps=base.slot_prefix_caps(batch, slots),
    )


def random_operands(name: str, batch: dict, prec, device, seed: int) -> dict:
    """Whole-model kernel operands at full width on a real bucket's slot or
    ELL layout: GIN's from seeded random tensors, the other models' from the
    model's own operand function over seeded synthetic weights (so the degree
    norms, scalers and eigenvector terms are the bucket's own)."""
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    if name in ("gin", "gin-vn"):
        return gin_random_operands(batch, name == "gin-vn", prec.compute_dtype, device, seed)
    params = params_from_numpy(synthetic_params(name, seed), prec, device)
    return kernel_calls(whole_kernel(name, batch), name, params, [batch], prec)[0]


def whole_kernel(name: str, batch: dict) -> str:
    slot, ell, _ = MODEL_KERNELS[name]
    return ell if "loc_ell" in batch else slot


def agree(got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises unless
    |got − want| ≤ tol·scale + tol·|want| elementwise, where scale is the
    largest |want| (at least 1). Rounding error grows with the magnitude
    of the summed terms, not of each result: a prediction near zero is a
    sum of terms as large as the largest prediction, and GIN-VN's
    synthetic-weight predictions reach thousands."""
    import torch

    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)
    return (got - want).abs().max().item()


def compare(kname: str, ops: dict, what: str, tol: float) -> float:
    """One kernel launch against its plain version on ``ops``; prints and
    returns the max abs error."""
    import torch

    got = kernel_fn(kname)(**ops)
    want = kernel_fn(kname, plain=True)(**ops)
    torch.cuda.synchronize()
    err = agree(got, want, tol)
    print(f"# kernel vs plain, {kname} {what}: max abs err {err:.3e} "
          f"(max |out| {want.float().abs().max().item():.3e})")
    return err


def check_kernel(name: str, batch: dict, device, what: str) -> float:
    """One model's whole-model kernel against its plain version on
    ``batch``'s layout, f32 and bf16; returns the f32 error."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32

    kname = whole_kernel(name, batch)
    errs = [compare(kname, random_operands(name, batch, prec, device, SEED + 1),
                    f"{name} {what} {prec.compute_dtype}", tol)
            for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2))]
    return errs[0]


def check_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3: each slot kernel against its plain version on random
    operands."""
    for name in MODELS:
        kname = MODEL_KERNELS[name][0]
        err = check_kernel(name, streams[name, "molhiv", SLOTS][1][0], device, "molhiv W=128")
        max_err[kname] = max(max_err[kname], err)


def check_ell_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3b: each ELL kernel against its plain version at W=128, 256,
    384 and 512; the W=512 bucket holds the hep10k stream's largest graph."""
    from flowgnn_tpu_torch.models import base

    for name in ELL_MODELS:
        kname = MODEL_KERNELS[name][1]
        buckets, batches, _ = streams[name, "hep10k", ELL]
        sizes = [int(b.n_node[: b.num_graphs].max()) for b in buckets]
        i = max(range(len(buckets)), key=sizes.__getitem__)
        largest = sizes[i]
        check(largest >= 385, f"{name}: the largest hep10k graph has {largest} nodes")
        cases = [
            (streams[name, "molhiv", ELL][1][0], "molhiv bucket"),
            (big_graph_bucket(name, 250, device), "synthetic bucket, 250-node graphs"),
            (big_graph_bucket(name, 380, device), "synthetic bucket, 380-node graphs"),
            (batches[i], f"hep10k bucket {i}, a {largest}-node graph"),
        ]
        for batch, what in cases:
            what = f"W={base.ell_geometry(batch)[0]} {what}"
            max_err[kname] = max(max_err[kname], check_kernel(name, batch, device, what))


def check_layer_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3c: each per-layer slot kernel and the spill scatter against
    its plain version on layer 0's operands of the hep10k W=128 bucket with
    the longest spill tail, f32 (1e-4) and bf16 (5e-2), seeded synthetic
    weights."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    for name in SPILL_MODELS:
        _, batches, _ = streams[name, "hep10k", SLOTS]
        i = max(range(len(batches)), key=lambda j: int(batches[j]["slot_spill_mask"].sum()))
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(synthetic_params(name, SEED + 1), prec, device)
            kernels = model_module(name).layer_kernel_operands(params, batches[i], prec)
            for kname, ops in kernels.items():
                err = compare(kname, ops, f"{name} hep10k W=128 bucket {i} layer 0 "
                              f"{prec.compute_dtype}", tol)
                if prec is FLOAT32:
                    max_err[kname] = max(max_err[kname], err)


def run_main_path(streams: dict, device, keys) -> dict:
    """Phases 4, 4b and 4c: each (model, profile, layout) of ``keys`` over
    its whole stream in f32 and bf16; returns each kernel's launches
    counted in these runs.

    The reference is the port's plain edge-list path in f32 on the same
    device (``agree``). The f32 kernel path differs from it in summation
    order only: 1e-4. bf16 keeps about three significant digits, and a
    prediction is a mean of node outputs that partly cancel, so single
    graphs move by a few percent of the largest prediction: 5e-2. The bf16
    plain path's own error against the same reference is printed beside."""
    import collections

    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward = registry.get(name).forward
        params_np = synthetic_params(name, SEED)
        p32 = params_from_numpy(params_np, FLOAT32, device)
        want = [forward(p32, pb, FLOAT32)[: b.num_graphs] for b, pb in zip(buckets, plain)]
        expect = collections.Counter()
        for b in batches:
            expect.update(bucket_launches(name, b))
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(params_np, prec, device)
            for k in kernels.values():
                k.launches = 0
            outs = [forward(params, b, prec) for b in batches]
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kernels.items()}
            check(counts == {k: expect.get(k, 0) for k in KERNELS},
                  f"{key}: launches {counts}, expected {dict(expect)}")
            for k, c in counts.items():
                launches[k] += c
            for i, (packed, out, pb, w) in enumerate(zip(buckets, outs, plain, want)):
                k = packed.num_graphs
                check(tuple(out.shape) == (packed.n_node.shape[0], 1), f"{key}: shape {tuple(out.shape)}")
                check(bool(out[:k].isfinite().all()), f"{key}: non-finite output")
                err = agree(out[:k], w, tol)
                line = (f"# main path {name} {profile} {layout} {prec.compute_dtype} bucket {i}: "
                        f"{k} graphs, launches {dict(bucket_launches(name, batches[i]))}, "
                        f"max abs err vs f32 plain path {err:.3e}")
                if prec is BF16:
                    plain_err = (forward(params, pb, prec)[:k].float() - w).abs().max().item()
                    line += f" (bf16 plain path: {plain_err:.3e})"
                print(f"{line}; max |out| {w.abs().max().item():.3e}")
    return launches


def describe_ell(streams: dict) -> None:
    """Phase 4b's geometry: W, k, spill lanes and the fullest window's lanes
    per ELL stream; k must be 1 and no lane may spill."""
    from flowgnn_tpu_torch.models import base

    for (name, profile, layout), (buckets, batches, _) in streams.items():
        if layout != ELL:
            continue
        for i, b in enumerate(batches):
            w, k = base.ell_geometry(b)
            lanes = b["loc_ulocal"].shape[0]
            spill = b["senders"].shape[0] - lanes
            nw = -(-b["node_feat"].shape[0] // w)
            fullest = int((b["loc_vlocal"].reshape(nw, -1) < w).sum(1).max())
            check(k == 1 and spill == 0, f"{name} {profile} bucket {i}: k={k}, {spill} spill lanes")
            print(f"# ELL {name} {profile} bucket {i}: {buckets[i].num_graphs} graphs, W={w}, "
                  f"k={k}, {lanes // nw} lanes per window, spill lanes {spill}, "
                  f"fullest window {fullest} lanes, largest graph "
                  f"{int(buckets[i].n_node[: buckets[i].num_graphs].max())} nodes")


def describe_spill(streams: dict) -> None:
    """Phase 4c's geometry: per hep10k W=128 slot stream and bucket, the
    slots, the real spill lanes, the blocked lanes and the compact scatter
    windows T; every bucket must spill."""
    for name in SPILL_MODELS:
        buckets, batches, _ = streams[name, "hep10k", SLOTS]
        for i, b in enumerate(batches):
            real = int(b["slot_spill_mask"].sum())
            t = b["spill_blk_compact"].shape[0]
            check(real > 0, f"{name} hep10k bucket {i}: no spill tail")
            print(f"# spill {name} hep10k bucket {i}: {buckets[i].num_graphs} graphs, "
                  f"W={b['slot_geom'].shape[0]}, S={b['slot_geom'].shape[1]}, spill lanes "
                  f"{real} of {b['senders'].shape[0]} edges, {b['slot_spill'].shape[0]} blocked "
                  f"lanes in {b['spill_blk_window'].shape[0]} blocks, compact windows T={t} "
                  f"of {b['spill_blk_winmap'].shape[0]}")


def check_ell_matches_slots(streams: dict, device) -> dict:
    """Phase 4b, molhiv at W=128: the ELL path's f32 predictions against the
    slot path's (both kernel paths; summation order only: 1e-4). Returns the
    ELL kernels' launches, counted as in ``run_main_path``."""
    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: kernel_fn(k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for name in ELL_MODELS:
        forward = registry.get(name).forward
        params = params_from_numpy(synthetic_params(name, SEED), FLOAT32, device)
        buckets, ell, _ = streams[name, "molhiv", ELL]
        slot = streams[name, "molhiv", SLOTS][1]
        want = [forward(params, b, FLOAT32) for b in slot]
        kname = MODEL_KERNELS[name][1]
        for k in kernels.values():
            k.launches = 0
        outs = [forward(params, b, FLOAT32) for b in ell]
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in kernels.items()}
        check(counts[kname] == len(ell) and sum(counts.values()) == len(ell),
              f"{name} molhiv ELL: launches {counts}")
        launches[kname] += counts[kname]
        for i, (packed, out, w) in enumerate(zip(buckets, outs, want)):
            k = packed.num_graphs
            err = agree(out[:k], w[:k], 1e-4)
            print(f"# molhiv {name} f32 bucket {i}: ELL path (W=128) vs slot path, max abs err "
                  f"{err:.3e}; max |out| {w[:k].abs().max().item():.3e}")
    return launches


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def valid_lanes(ops: dict) -> int:
    """The lanes of a kernel's layout that carry an edge: the work its
    message loop does on this data."""
    w = ops["window"]
    if "slot_meta" in ops:
        src = ops["slot_meta"][:, 0] + (w // 2 if w <= 512 else 0)
        return int(((src >= 0) & (src < w)).sum())
    if "ell_meta" in ops:
        m = ops["ell_meta"]
        return int(((m[:, 0] >= 0) & (m[:, 0] < w) & (m[:, 1] >= 0) & (m[:, 1] < w)).sum())
    key = next(k for k in ("slot_pstack", "slot_src", "slot_stack", "v_local") if k in ops)
    return int((ops[key] < w).sum())


def work(kname: str, ops: dict, out) -> tuple[float, float]:
    """(operations, bytes) of one launch on ``ops``: each input read once
    and the output written once; operations count a multiply-add as two,
    over the lanes that carry an edge (E) and the rows of h (n), for the
    dominant terms (PERF.md gives the formulas)."""
    import torch

    byts = sum(nbytes(v) for v in ops.values() if torch.is_tensor(v)) + nbytes(out)
    e = valid_lanes(ops)
    L = ops.get("num_layers", 1)
    h = ops["h0"] if "h0" in ops else ops.get("h", ops.get("values"))
    n, d = h.shape
    if kname in ("gin_local_model_slots", "gin_local_model"):
        hid, t = ops["w1_all"].shape[0] // L, ops["pred_w"].shape[1]
        ops_ = L * (4 * e * d + 4 * n * d * hid) + 2 * n * d * t
    elif kname in ("gcn_local_model_slots", "gcn_local_model"):
        ops_ = L * 5 * e * d + (L - 1) * 2 * n * d * d + 2 * n * d * ops["pred_w"].shape[1]
    elif kname == "pna_local_model":
        ops_ = L * (5 * e * d + 24 * n * d * d) + 2 * n * d * ops["mlp1_w"].shape[1]
    elif kname == "dgn_local_model":
        ops_ = L * (3 * e * d + 4 * n * d * d) + 2 * n * d * ops["mlp1_w"].shape[1]
    elif kname == "gat_local_model_slots":
        nh = ops["num_heads"]
        ops_ = (L * (4 * n * d * nh + e * (2 * d + 4 * nh)) + (L - 1) * 4 * n * d * d
                + 2 * n * d * ops["pred_hd"].shape[1])
    elif kname == "pna_local_stats_ell":
        ops_ = 5 * e * d
    elif kname == "dgn_local_layer_slots":
        ops_ = 3 * e * d + 4 * n * d * d
    elif kname == "gat_local_message_slots":
        ops_ = e * (2 * d + 4 * ops["num_heads"])
    else:  # the spill scatter: one add per lane and column
        ops_ = e * d
    return float(ops_), float(byts)


def time_paths(streams: dict, device, keys) -> dict:
    """Phases 5 and 5b: per (model, profile, layout) of ``keys`` and dtype,
    the end-to-end µs/graph of the kernel path and of the plain edge-list
    path, and per kernel of the path its ms per stream alone, its plain
    version's, its bound, and for the spill scatter PyTorch's
    ``index_add_`` into [n, D'] of the same values. Returns those per
    (kernel, key, dtype)."""
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    record = {}
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward = registry.get(name).forward
        graphs = sum(b.num_graphs for b in buckets)
        params_np = synthetic_params(name, SEED)
        kernels = sorted(bucket_launches(name, batches[0]))
        for prec in (BF16, FLOAT32):
            dt = str(prec.compute_dtype).replace("torch.", "")
            params = params_from_numpy(params_np, prec, device)
            tag = f"{name} {profile} {layout} {dt}"
            e2e = cuda_ms(lambda: [forward(params, b, prec) for b in batches])
            e2e_plain = cuda_ms(lambda: [forward(params, b, prec) for b in plain])
            print(f"# time {tag}: kernel path {e2e * 1e3 / graphs:.4f} us/graph, "
                  f"plain edge-list path {e2e_plain * 1e3 / graphs:.4f} us/graph ({graphs} graphs)")
            for kname in kernels:
                calls = kernel_calls(kname, name, params, batches, prec)
                kernel, ref = kernel_fn(kname), kernel_fn(kname, plain=True)
                outs = [kernel(**o) for o in calls]
                flops, byts = map(sum, zip(*(work(kname, o, out) for o, out in zip(calls, outs))))
                t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, byts / MEM_BYTES_PER_S * 1e3
                rec = dict(
                    ms=cuda_ms(lambda: [kernel(**o) for o in calls]),
                    plain_ms=cuda_ms(lambda: [ref(**o) for o in calls]),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=None,
                )
                line = ""
                if kname == SCATTER:
                    # The same sums as one PyTorch call: the spill values
                    # index-added at their receivers into [n, D'].
                    lib = [(b["node_feat"].shape[0], base.spill_lanes(b)[1], o["values"])
                           for b, o in zip(batches, calls[:: num_layers(name)])]
                    lib = [x for x in lib for _ in range(num_layers(name))]
                    rec["library_ms"] = cuda_ms(lambda: [
                        torch.zeros(n, v.shape[1], dtype=v.dtype, device=device).index_add_(0, r, v)
                        for n, r, v in lib])
                    line = f", index_add_ {rec['library_ms']:.4f} ms"
                print(f"# time {tag}: {kname} alone {rec['ms']:.4f} ms/stream ({len(calls)} "
                      f"launches), its plain version {rec['plain_ms']:.4f} ms{line}; bound "
                      f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({flops:.4g} operations, "
                      f"{byts:.4g} bytes)")
                record[(kname, key, prec)] = rec
    return record


def profile_path(key: tuple, streams: dict, device) -> None:
    """``--profile``: ``torch.profiler`` over ``PROFILE_PASSES`` bf16 passes
    of one path's whole stream, after 3 warm-up passes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    name, passes = key[0], PROFILE_PASSES
    _, batches, _ = streams[key]
    forward = registry.get(name).forward
    params = params_from_numpy(synthetic_params(name, SEED), BF16, device)
    run = lambda: [forward(params, b, BF16) for b in batches]
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / passes
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # Device-side events only: an ATen operator also carries its kernels' time.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_time(e) > 0),
                     key=dev_time, reverse=True)
    busy = sum(dev_time(e) for e in kernels) / 1e3 / passes
    launches = sum(e.count for e in kernels) / passes
    print(f"# profile {' '.join(key)} bf16: wall {wall:.3f} ms/pass, device busy {busy:.3f} "
          f"ms/pass, idle share {1 - busy / wall:.1%}, {launches:.0f} device kernels per pass")
    for e in kernels[:8]:
        print(f"#   device {dev_time(e) / 1e3 / passes:8.3f} ms/pass  {e.count // passes:5d}x  {e.key[:90]}")
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:8]:
        print(f"#   host   {e.self_cpu_time_total / 1e3 / passes:8.3f} ms/pass  "
              f"{e.count // passes:5d}x  {e.key}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="profile the hep10k spill paths only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flowgnn_tpu_torch.core.numerics import BF16
    from flowgnn_tpu_torch.ops import build, local_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if args.profile:
        print(smi)
        for name in SPILL_MODELS:
            key = (name, "hep10k", SLOTS)
            streams = {key: make_stream(name, "hep10k", HEP_GRAPHS, SLOTS, dev, window=SPILL_WINDOW)}
            profile_path(key, streams, dev)
        return 0
    kind = torch.cuda.get_device_name(0)
    print(f"# device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. Build, all sources at once.
    t0 = time.perf_counter()
    libs = build.build_libraries(local_layer.LIBRARIES)
    for name in local_layer.LIBRARIES:
        local_layer._library(name)
    print(f"# build of {len(libs)} kernels: {time.perf_counter() - t0:.1f} s")
    for so in libs:
        print(f"# {so.name}:")
        for line in so.with_suffix(".log").read_text().splitlines():
            print(f"#   {line}")

    # The main paths' host half (phases 3, 3b and 3c run on real buckets' layouts).
    t0 = time.perf_counter()
    streams = {(name, "molhiv", SLOTS): make_stream(name, "molhiv", STREAM_GRAPHS, SLOTS, dev)
               for name in MODELS}
    for name in ELL_MODELS:
        for profile, count in (("hep10k", HEP_GRAPHS), ("molhiv", STREAM_GRAPHS)):
            streams[name, profile, ELL] = make_stream(name, profile, count, ELL, dev)
    for name in SPILL_MODELS:
        streams[name, "hep10k", SLOTS] = make_stream(name, "hep10k", HEP_GRAPHS, SLOTS, dev,
                                                     window=SPILL_WINDOW)
    for (name, profile, layout), (buckets, batches, _) in streams.items():
        if layout == SLOTS and profile == "molhiv":
            w, s = batches[0]["slot_geom"].shape
            nw = -(-batches[0]["node_feat"].shape[0] // w)
            print(f"# {name}: {len(buckets)} buckets, {sum(b.num_graphs for b in buckets)} "
                  f"graphs, window {w}, slots {s}, prefix lanes per window "
                  f"{batches[0]['slot_meta'].shape[0] // nw}")
    describe_ell(streams)
    describe_spill(streams)
    print(f"# host pack of {len(streams)} streams: {time.perf_counter() - t0:.1f} s")

    # 3. Kernels against their plain versions; 4. the main paths; 5. timings.
    slot_keys = [(name, "molhiv", SLOTS) for name in MODELS]
    hep_keys = [(name, "hep10k", ELL) for name in ELL_MODELS]
    spill_keys = [(name, "hep10k", SLOTS) for name in SPILL_MODELS]
    max_err = dict.fromkeys(KERNELS, 0.0)
    check_kernels(streams, dev, max_err)
    check_ell_kernels(streams, dev, max_err)
    check_layer_kernels(streams, dev, max_err)
    launches = run_main_path(streams, dev, slot_keys + hep_keys + spill_keys)
    for k, n in check_ell_matches_slots(streams, dev).items():
        launches[k] += n
    molhiv_ell_keys = [(name, "molhiv", ELL) for name in ELL_MODELS]
    record = time_paths(streams, dev, slot_keys + hep_keys + molhiv_ell_keys + spill_keys)

    print(smi)
    kernels = []
    for kname, (_, source, replaces, key) in KERNELS.items():
        check(launches[kname] > 0, f"{kname}: no launch on the main paths")
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            **record[(kname, key, BF16)],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
