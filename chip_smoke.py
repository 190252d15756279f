"""Smoke run of the PyTorch / CUDA port (flowgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. the device and ``nvidia-smi``'s name and power limit;
2. the hand-written kernel built from ``flowgnn_tpu_torch/csrc`` (build time
   and the compiler's register / shared-memory report);
3. the kernel against its plain torch version on the card, at the main
   path's shapes (a real bucket's slot layout, D=100, H=200, L=5) with
   seeded random operands: f32 at rtol = atol = 1e-4 (summation order only),
   bf16 at 5e-2, with and without the analytic-VN column (tolerances as in
   ``agree``);
4. the main path: GIN and GIN-VN over the 4113-graph synthetic molhiv stream
   at full width with seeded synthetic weights, f32 and bf16, through
   ``registry`` → ``pack_dataset`` → ``as_batches_uniform(local_slots)`` →
   ``gin.forward``. The kernel's launch count must rise by exactly one per
   bucket, and each bucket's predictions must match the port's plain
   edge-list path in f32 on the card (f32 1e-4, bf16 5e-2, see
   ``run_main_path``);
5. CUDA-event timings after warm-up: µs/graph over the whole stream for the
   kernel path and for the plain edge-list path, and the kernel alone
   against its plain version on the same operands.

The line before the last is a JSON object with the kernel's record; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
STREAM_GRAPHS = 4113  # molhiv's graph count
KERNEL_SOURCE = "flowgnn_tpu_torch/csrc/gin_local_model_slots.cu"
TPU_KERNEL = "flowgnn_tpu/ops/pallas/local_layer.py:944"


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


def make_stream(name: str, num_graphs: int, device):
    """The main path's host half for one model: (packed buckets, slot
    batches, plain batches), the batches on ``device``."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    graphs = registry.apply_transforms(
        spec, synthetic_dataset("molhiv", seed=SEED, num_graphs=num_graphs)
    )
    window, _ = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    buckets = list(pack_dataset(
        graphs, node_capacity=NODE_CAP,
        edge_capacity=auto_edge_capacity(graphs, NODE_CAP),
        graph_capacity=GRAPH_CAP, align_window=window,
    ))
    slot = base.as_batches_uniform(buckets, blocked="local_slots", window=window)
    return (
        buckets,
        [base.to_device(b, device) for b in slot],
        [base.to_device(base.as_batch(b), device) for b in buckets],
    )


def random_operands(batch: dict, vn: bool, dtype, device, seed: int) -> dict:
    """Kernel operands at full width on a real bucket's slot layout, with
    seeded random h0 and weights."""
    import numpy as np
    import torch

    from flowgnn_tpu_torch.models import base

    L, D, H = 5, 100, 200
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32)).to(device, dtype)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=t(n, D), pool_gl=batch["pool_gl"],
        ee_tables=t(L * 13, D), w1_all=t(L * H, D), b1_all=t(L, H),
        w2_all=t(L * D, H), b2_all=t(L, D),
        eps_all=(1 + t(L, 1)).float(), pred_w=t(D, 1),
        window=batch["slot_geom"].shape[0], slots=slots, num_layers=L,
        gmax=base.POOL_GMAX, prefix_caps=base.slot_prefix_caps(batch, slots),
        vn_col=batch["vn_mask"].to(dtype) if vn else None,
    )


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


def check_kernel(streams: dict, device) -> float:
    """Phase 3: the kernel against its plain version on random operands.
    Returns the largest f32 error."""
    import torch

    from flowgnn_tpu_torch.ops import local_layer

    max_err = 0.0
    for name in ("gin", "gin-vn"):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            ops = random_operands(streams[name][1][0], name == "gin-vn", dtype, device, SEED + 1)
            got = local_layer.gin_local_model_slots(**ops)
            want = local_layer.gin_local_model_slots_ref(**ops)
            err = agree(got, want, tol)
            print(f"# kernel vs plain, {name} {dtype}: max abs err {err:.3e} "
                  f"(max |out| {want.abs().max().item():.3e})")
            if dtype == torch.float32:
                max_err = max(max_err, err)
    return max_err


def run_main_path(streams: dict, params_np: dict, device) -> int:
    """Phase 4: both models over the whole stream in f32 and bf16; returns
    the kernel launches counted in these runs.

    The reference is the port's plain edge-list path in f32 on the same
    device (``agree``). The f32 kernel path differs from it in summation
    order only: 1e-4. bf16 keeps about three significant digits, and a
    prediction is a mean of node outputs that partly cancel, so single
    graphs move by a few percent of the largest prediction: 5e-2. The
    bf16 plain path's own error against the same reference is printed
    beside."""
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy

    kernel = local_layer.gin_local_model_slots
    launches = 0
    for name, (buckets, slot, plain) in streams.items():
        forward = registry.get(name).forward
        p32 = params_from_numpy(params_np, FLOAT32, device)
        want = [forward(p32, pb, FLOAT32)[: b.num_graphs] for b, pb in zip(buckets, plain)]
        for prec, tol in ((FLOAT32, 1e-4), (BF16, 5e-2)):
            params = params_from_numpy(params_np, prec, device)
            kernel.launches = 0
            outs = [forward(params, b, prec) for b in slot]
            torch.cuda.synchronize()
            count = kernel.launches
            launches += count
            check(count == len(slot), f"{name}: {count} launches for {len(slot)} buckets")
            for i, (packed, out, pb, w) in enumerate(zip(buckets, outs, plain, want)):
                k = packed.num_graphs
                check(tuple(out.shape) == (packed.n_node.shape[0], 1), f"{name}: shape {tuple(out.shape)}")
                check(bool(out[:k].isfinite().all()), f"{name}: non-finite output")
                err = agree(out[:k], w, tol)
                line = (f"# main path {name} {prec.compute_dtype} bucket {i}: {k} graphs, "
                        f"{count} launches, max abs err vs f32 plain path {err:.3e}")
                if prec is BF16:
                    plain_err = (forward(params, pb, prec)[:k].float() - w).abs().max().item()
                    line += f" (bf16 plain path: {plain_err:.3e})"
                print(f"{line}; max |out| {w.abs().max().item():.3e}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import gin, registry
    from flowgnn_tpu_torch.ops import build, local_layer
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

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

    # 2. Build.
    t0 = time.perf_counter()
    so = build.build_library(local_layer.LIBRARY)
    local_layer._library()
    print(f"# build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        print(f"#   {line}")

    # The main path's host half (phase 3 runs on a real bucket's layout).
    t0 = time.perf_counter()
    params_np = synthetic_gin_params(SEED)
    streams = {name: make_stream(name, STREAM_GRAPHS, dev) for name in ("gin", "gin-vn")}
    for name, (buckets, slot, _) in streams.items():
        w, s = slot[0]["slot_geom"].shape
        nw = -(-slot[0]["node_feat"].shape[0] // w)
        print(f"# {name}: {len(buckets)} buckets, {sum(b.num_graphs for b in buckets)} "
              f"graphs, window {w}, slots {s}, prefix lanes per window "
              f"{slot[0]['slot_meta'].shape[0] // nw}")
    print(f"# host pack of both streams: {time.perf_counter() - t0:.1f} s")

    # 3. Kernel against its plain version; 4. the main path.
    max_err = check_kernel(streams, dev)
    launches = run_main_path(streams, params_np, dev)

    # 5. Timings.
    kernel = local_layer.gin_local_model_slots
    record = {}
    for name, (buckets, slot, plain) in streams.items():
        forward = registry.get(name).forward
        graphs = sum(b.num_graphs for b in buckets)
        for prec in (BF16, FLOAT32):
            params = params_from_numpy(params_np, prec, dev)
            ops = [gin.slot_kernel_operands(params, b, prec) for b in slot]
            tag = f"{name} {str(prec.compute_dtype).replace('torch.', '')}"
            e2e = cuda_ms(lambda: [forward(params, b, prec) for b in slot])
            e2e_plain = cuda_ms(lambda: [forward(params, b, prec) for b in plain])
            k_ms = cuda_ms(lambda: [kernel(**o) for o in ops])
            ref_ms = cuda_ms(lambda: [local_layer.gin_local_model_slots_ref(**o) for o in ops])
            print(f"# time {tag}: kernel path {e2e * 1e3 / graphs:.4f} us/graph, "
                  f"plain edge-list path {e2e_plain * 1e3 / graphs:.4f} us/graph; "
                  f"kernel alone {k_ms:.4f} ms/stream, its plain version {ref_ms:.4f} "
                  f"ms/stream ({graphs} graphs, {len(slot)} launches)")
            record[(name, prec)] = (k_ms, ref_ms)

    k_ms, ref_ms = record[("gin", BF16)]  # the bench default: GIN in bf16
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "gin_local_model_slots", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": ref_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
