"""Smoke run of the PyTorch / CUDA port (flowgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. the device and ``nvidia-smi``'s name and power limit;
2. the hand-written kernels built from ``flowgnn_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together (build time and each
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
4. the main path: GIN, GIN-VN, GCN, PNA, DGN and GAT, each over the
   4113-graph synthetic molhiv stream at full width with seeded synthetic
   weights, f32 and bf16, through ``registry`` → ``pack_dataset`` →
   ``as_batches_uniform(local_slots)`` → ``registry.get(name).forward``.
   Every kernel's launch count is set to 0 just before each run and read
   just after: the model's kernel must have run exactly once per bucket and
   no other kernel at all. Each bucket's predictions must match the port's
   plain edge-list path in f32 on the card (f32 1e-4, bf16 5e-2, see
   ``run_main_path``);
4b. the ELL path: GIN, GIN-VN and GCN over the 2048-graph synthetic hep10k
   stream at W=512 (``as_batches_uniform(local_ell)``, k=1, no spill), f32
   and bf16, counted and checked as in phase 4; then over the molhiv stream
   at W=128, whose predictions must match the slot path's (f32 1e-4);
5. CUDA-event timings after warm-up, per model and dtype: µs/graph over the
   whole stream for the kernel path and for the plain edge-list path, and
   the kernel alone against its plain version on the same operands;
5b. the same for the hep10k ELL path, and for the molhiv stream through
   the ELL kernels at W=128 (beside phase 5's slot kernels).

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
STREAM_GRAPHS = 4113  # molhiv's graph count
HEP_GRAPHS = 2048  # the JAX bench's default hep10k sample (bench.py)
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
ELL_MODELS = ("gin", "gin-vn", "gcn")
SLOTS, ELL = "local_slots", "local_ell"
MAIN_PROFILE = {SLOTS: "molhiv", ELL: "hep10k"}
# Kernel → (source, the TPU kernel it replaces, the (model, layout) paths
# that run it). The first path's bf16 stream of the layout's main profile
# gives the record's times.
KERNELS = {
    "gin_local_model_slots": (
        "flowgnn_tpu_torch/csrc/gin_local_model_slots.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:944", (("gin", SLOTS), ("gin-vn", SLOTS)),
    ),
    "gcn_local_model_slots": (
        "flowgnn_tpu_torch/csrc/gcn_local_model_slots.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:1178", (("gcn", SLOTS),),
    ),
    "pna_local_model": (
        "flowgnn_tpu_torch/csrc/pna_local_model.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:2062", (("pna", SLOTS),),
    ),
    "dgn_local_model": (
        "flowgnn_tpu_torch/csrc/dgn_local_model.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:3104", (("dgn", SLOTS),),
    ),
    # One kernel for the three GAT megakernels, which compute one function.
    "gat_local_model_slots": (
        "flowgnn_tpu_torch/csrc/gat_local_model_slots.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:2567 (gat_local_model_pairs), "
        ":2350 (gat_local_model_slots), :2835 (gat_local_model_dense)", (("gat", SLOTS),),
    ),
    "gin_local_model": (
        "flowgnn_tpu_torch/csrc/gin_local_model.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:576", (("gin", ELL), ("gin-vn", ELL)),
    ),
    "gcn_local_model": (
        "flowgnn_tpu_torch/csrc/gcn_local_model.cu",
        "flowgnn_tpu/ops/pallas/local_layer.py:767", (("gcn", ELL),),
    ),
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


def kernel_of(name: str, layout: str) -> str:
    return next(k for k, (_, _, paths) in KERNELS.items() if (name, layout) in paths)


def model_module(name: str):
    from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna

    return {"gin": gin, "gin-vn": gin, "gcn": gcn, "pna": pna, "dgn": dgn, "gat": gat}[name]


def kernel_operands(name: str, params: dict, batch: dict, prec) -> dict:
    """The operands a model's slot or ELL branch hands its kernel."""
    mod = model_module(name)
    return (mod.ell_kernel_operands if "loc_ell" in batch else mod.slot_kernel_operands)(
        params, batch, prec)


def synthetic_params(name: str, seed: int) -> dict:
    from flowgnn_tpu_torch.params import loaders

    return {
        "gin": loaders.synthetic_gin_params, "gin-vn": loaders.synthetic_gin_params,
        "gcn": loaders.synthetic_gcn_params, "pna": loaders.synthetic_pna_params,
        "dgn": loaders.synthetic_dgn_params, "gat": loaders.synthetic_gat_params,
    }[name](seed)


def make_stream(name: str, profile: str, num_graphs: int, layout: str, device):
    """The main path's host half for one model: (packed buckets, kernel
    batches in ``layout``, plain batches), the batches on ``device``."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    graphs = registry.apply_transforms(
        spec, synthetic_dataset(profile, seed=SEED, num_graphs=num_graphs)
    )
    window, block = base.choose_geometry(name, max(g.num_nodes for g in graphs))
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
    """Kernel operands at full width on a real bucket's slot or ELL layout:
    GIN's from seeded random tensors, the other models' from the model's
    own operand builder over seeded synthetic weights (so the degree norms,
    scalers and eigenvector terms are the bucket's own)."""
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    if name in ("gin", "gin-vn"):
        return gin_random_operands(batch, name == "gin-vn", prec.compute_dtype, device, seed)
    params = params_from_numpy(synthetic_params(name, seed), prec, device)
    return kernel_operands(name, params, batch, prec)


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


def check_kernel(name: str, batch: dict, device, what: str) -> float:
    """One model's kernel against its plain version on ``batch``'s layout,
    f32 and bf16; returns the f32 error."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.ops import local_layer

    kname = kernel_of(name, ELL if "loc_ell" in batch else SLOTS)
    kernel = getattr(local_layer, kname)
    ref = getattr(local_layer, f"{kname}_ref")
    for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
        ops = random_operands(name, batch, prec, device, SEED + 1)
        got = kernel(**ops)
        want = ref(**ops)
        err = agree(got, want, tol)
        print(f"# kernel vs plain, {kname} {name} {what} {prec.compute_dtype}: max abs err "
              f"{err:.3e} (max |out| {want.abs().max().item():.3e})")
        if prec is FLOAT32:
            f32_err = err
    return f32_err


def check_kernels(streams: dict, device) -> dict:
    """Phase 3: each slot kernel against its plain version on random
    operands. Returns each kernel's largest f32 error."""
    max_err = dict.fromkeys(KERNELS, 0.0)
    for name in MODELS:
        kname = kernel_of(name, SLOTS)
        err = check_kernel(name, streams[name, "molhiv", SLOTS][1][0], device, "molhiv W=128")
        max_err[kname] = max(max_err[kname], err)
    return max_err


def check_ell_kernels(streams: dict, device, max_err: dict) -> None:
    """Phase 3b: each ELL kernel against its plain version at W=128, 256,
    384 and 512; the W=512 bucket holds the hep10k stream's largest graph."""
    from flowgnn_tpu_torch.models import base

    for name in ELL_MODELS:
        kname = kernel_of(name, ELL)
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


def run_main_path(streams: dict, device, keys) -> dict:
    """Phases 4 and 4b: each (model, profile, layout) of ``keys`` over its
    whole stream in f32 and bf16; returns each kernel's launches counted in
    these runs.

    The reference is the port's plain edge-list path in f32 on the same
    device (``agree``). The f32 kernel path differs from it in summation
    order only: 1e-4. bf16 keeps about three significant digits, and a
    prediction is a mean of node outputs that partly cancel, so single
    graphs move by a few percent of the largest prediction: 5e-2, for all
    six models. The bf16 plain path's own error against the same
    reference is printed beside."""
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: getattr(local_layer, k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward = registry.get(name).forward
        params_np = synthetic_params(name, SEED)
        p32 = params_from_numpy(params_np, FLOAT32, device)
        want = [forward(p32, pb, FLOAT32)[: b.num_graphs] for b, pb in zip(buckets, plain)]
        kname = kernel_of(name, layout)
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(params_np, prec, device)
            for k in kernels.values():
                k.launches = 0
            outs = [forward(params, b, prec) for b in batches]
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kernels.items()}
            launches[kname] += counts[kname]
            check(counts[kname] == len(batches),
                  f"{key}: {counts[kname]} launches of {kname} for {len(batches)} buckets")
            check(all(c == 0 for k, c in counts.items() if k != kname),
                  f"{key}: other kernels launched: {counts}")
            for i, (packed, out, pb, w) in enumerate(zip(buckets, outs, plain, want)):
                k = packed.num_graphs
                check(tuple(out.shape) == (packed.n_node.shape[0], 1), f"{key}: shape {tuple(out.shape)}")
                check(bool(out[:k].isfinite().all()), f"{key}: non-finite output")
                err = agree(out[:k], w, tol)
                line = (f"# main path {name} {profile} {layout} {prec.compute_dtype} bucket {i}: "
                        f"{k} graphs, {counts[kname]} launches, max abs err vs f32 plain path {err:.3e}")
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


def check_ell_matches_slots(streams: dict, device) -> dict:
    """Phase 4b, molhiv at W=128: the ELL path's f32 predictions against the
    slot path's (both kernel paths; summation order only: 1e-4). Returns the
    ELL kernels' launches, counted as in ``run_main_path``."""
    import torch

    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernels = {k: getattr(local_layer, k) for k in KERNELS}
    launches = dict.fromkeys(KERNELS, 0)
    for name in ELL_MODELS:
        forward = registry.get(name).forward
        params = params_from_numpy(synthetic_params(name, SEED), FLOAT32, device)
        buckets, ell, _ = streams[name, "molhiv", ELL]
        slot = streams[name, "molhiv", SLOTS][1]
        want = [forward(params, b, FLOAT32) for b in slot]
        kname = kernel_of(name, ELL)
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


def time_paths(streams: dict, device, keys) -> dict:
    """Phases 5 and 5b: per (model, profile, layout) of ``keys`` and dtype,
    (kernel alone ms, its plain version ms) per stream, with the end-to-end
    µs/graph of both paths printed."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    record = {}
    for key in keys:
        name, profile, layout = key
        buckets, batches, plain = streams[key]
        forward = registry.get(name).forward
        kname = kernel_of(name, layout)
        kernel = getattr(local_layer, kname)
        ref = getattr(local_layer, f"{kname}_ref")
        graphs = sum(b.num_graphs for b in buckets)
        params_np = synthetic_params(name, SEED)
        for prec in (BF16, FLOAT32):
            params = params_from_numpy(params_np, prec, device)
            ops = [kernel_operands(name, params, b, prec) for b in batches]
            tag = f"{name} {profile} {layout} {str(prec.compute_dtype).replace('torch.', '')}"
            e2e = cuda_ms(lambda: [forward(params, b, prec) for b in batches])
            e2e_plain = cuda_ms(lambda: [forward(params, b, prec) for b in plain])
            k_ms = cuda_ms(lambda: [kernel(**o) for o in ops])
            ref_ms = cuda_ms(lambda: [ref(**o) for o in ops])
            print(f"# time {tag}: kernel path {e2e * 1e3 / graphs:.4f} us/graph, "
                  f"plain edge-list path {e2e_plain * 1e3 / graphs:.4f} us/graph; "
                  f"kernel alone {k_ms:.4f} ms/stream, its plain version {ref_ms:.4f} "
                  f"ms/stream ({graphs} graphs, {len(batches)} launches)")
            record[(name, profile, layout, prec)] = (k_ms, ref_ms)
    return record


def main() -> int:
    import torch

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

    # The main paths' host half (phases 3 and 3b run on real buckets' layouts).
    t0 = time.perf_counter()
    streams = {(name, "molhiv", SLOTS): make_stream(name, "molhiv", STREAM_GRAPHS, SLOTS, dev)
               for name in MODELS}
    for name in ELL_MODELS:
        for profile, count in (("hep10k", HEP_GRAPHS), ("molhiv", STREAM_GRAPHS)):
            streams[name, profile, ELL] = make_stream(name, profile, count, ELL, dev)
    for (name, profile, layout), (buckets, batches, _) in streams.items():
        if layout == SLOTS:
            w, s = batches[0]["slot_geom"].shape
            nw = -(-batches[0]["node_feat"].shape[0] // w)
            print(f"# {name}: {len(buckets)} buckets, {sum(b.num_graphs for b in buckets)} "
                  f"graphs, window {w}, slots {s}, prefix lanes per window "
                  f"{batches[0]['slot_meta'].shape[0] // nw}")
    describe_ell(streams)
    print(f"# host pack of {len(streams)} streams: {time.perf_counter() - t0:.1f} s")

    # 3. Kernels against their plain versions; 4. the main paths; 5. timings.
    slot_keys = [(name, "molhiv", SLOTS) for name in MODELS]
    hep_keys = [(name, "hep10k", ELL) for name in ELL_MODELS]
    max_err = check_kernels(streams, dev)
    check_ell_kernels(streams, dev, max_err)
    launches = run_main_path(streams, dev, slot_keys + hep_keys)
    for k, n in check_ell_matches_slots(streams, dev).items():
        launches[k] += n
    molhiv_ell_keys = [(name, "molhiv", ELL) for name in ELL_MODELS]
    record = time_paths(streams, dev, slot_keys + hep_keys + molhiv_ell_keys)

    print(smi)
    kernels = []
    for kname, (source, replaces, paths) in KERNELS.items():
        check(launches[kname] > 0, f"{kname}: no launch on the main paths")
        name, layout = paths[0]
        k_ms, ref_ms = record[(name, MAIN_PROFILE[layout], layout, BF16)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": k_ms, "plain_ms": ref_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
