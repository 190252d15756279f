"""PNA's and DGN's slot kernels on their cells: rows 3 (``pna_local_model``)
and 4 (``dgn_local_model``), the whole-model kernels, and rows 20
(``pna_local_layer``) and 22 (``dgn_local_layer_slots``), their one-layer
forms, alone in ms per stream and as the model's forward over the stream in
µs per graph, bf16 and f32.

    python -m flowgnn_tpu_torch.bench.slot_kernels --label change

The cells are the streams ``chip_smoke.py`` times them on: the 4113-graph
synthetic molhiv stream in slots (W=128; rows 3 and 4 once per bucket, row
20 once per layer and bucket, the stream run with intermediates), the
2048-graph hep10k sample in slots at W=512 (rows 3 and 4 once per bucket,
rows 20 and 22 once per layer and bucket) and at W=128, where it spills
(row 22 once per layer and bucket, with the tail's channels), with seeded
synthetic weights. A per-layer kernel is timed on each bucket's layer-0
operands, once per layer, as ``chip_smoke.py`` does; the forward is the
path that runs the kernel (``return_intermediates`` on the cells of rows 20
and 22 with no spill tail). Each (kernel, cell, dtype) is timed with CUDA
events (3 warm-up passes, the mean of ``--reps``) and printed with the
launches per stream; a cell whose geometry a kernel refuses is printed as
refused with the wrapper's message, and the tool then exits 1. It uses
only the models' operand functions and the wrappers, so it times another
revision of the package as well: run it from that revision's checkout, in
turns with this one, to compare the two on one card. The card's name and
power limit are printed first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
# (kernel, model, profile, graphs, window; None: choose_geometry's).
CELLS = (
    ("pna_local_model", "pna", "molhiv", 4113, None),
    ("pna_local_model", "pna", "hep10k", 2048, 512),
    ("dgn_local_model", "dgn", "molhiv", 4113, None),
    ("dgn_local_model", "dgn", "hep10k", 2048, 512),
    ("pna_local_layer", "pna", "molhiv", 4113, None),
    ("pna_local_layer", "pna", "hep10k", 2048, 512),
    ("dgn_local_layer_slots", "dgn", "hep10k", 2048, 128),
    ("dgn_local_layer_slots", "dgn", "hep10k", 2048, 512),
)
LAYER_KERNELS = ("pna_local_layer", "dgn_local_layer_slots")


def stream(name: str, profile: str, graphs: int, window, device) -> list:
    """The slot batches of ``name``'s stream of ``profile`` at ``window``
    (None: the window ``choose_geometry`` gives its largest graph), on
    ``device``."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    gs = registry.apply_transforms(spec, synthetic_dataset(profile, seed=0, num_graphs=graphs))
    window = base.choose_geometry(name, window or max(g.num_nodes for g in gs))[0]
    buckets = list(pack_dataset(gs, node_capacity=NODE_CAP,
                                edge_capacity=auto_edge_capacity(gs, NODE_CAP),
                                graph_capacity=GRAPH_CAP, with_eigen=spec.needs_eigen,
                                align_window=window))
    return [base.to_device(b, device)
            for b in base.as_batches_uniform(buckets, blocked="local_slots", window=window)]


def calls(kernel: str, name: str, batches: list, prec, device) -> list:
    """The keyword operands of every launch of ``kernel`` over the stream:
    a whole-model kernel's per bucket, a per-layer kernel's layer-0 operands
    per bucket, once per layer."""
    from flowgnn_tpu_torch.models import dgn, pna
    from flowgnn_tpu_torch.params import loaders

    mod = {"pna": pna, "dgn": dgn}[name]
    make = {"pna": loaders.synthetic_pna_params, "dgn": loaders.synthetic_dgn_params}[name]
    params = loaders.params_from_numpy(make(0), prec, device)
    if kernel not in LAYER_KERNELS:
        return [mod.slot_kernel_operands(params, b, prec) for b in batches]
    layers = params["conv_w" if name == "pna" else "posttrans_w"].shape[0]
    return [mod.layer_kernel_operands(params, b, prec)[kernel] for b in batches
            for _ in range(layers)]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import registry
    from flowgnn_tpu_torch.ops import local_layer
    from flowgnn_tpu_torch.params import loaders

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="current", help="the revision's name in the output")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slot_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    from flowgnn_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_libraries(["pna_local_model", "dgn_local_model", "pna_local_layer_slots",
                           "dgn_local_layer_slots"])  # in parallel, before the first launch
    streams, refused = {}, 0
    for kernel, name, profile, graphs, window in CELLS:
        key = (name, profile, graphs, window)
        if key not in streams:
            streams[key] = stream(name, profile, graphs, window, dev)
        batches = streams[key]
        w = int(batches[0]["slot_geom"].shape[0])
        fn = getattr(local_layer, kernel)
        # The forward that runs the kernel: a no-spill bucket reaches rows 20
        # and 22 with intermediates only.
        inter = kernel in LAYER_KERNELS and not batches[0]["slot_spill"].shape[-1]
        forward = registry.get(name).forward
        make = {"pna": loaders.synthetic_pna_params, "dgn": loaders.synthetic_dgn_params}[name]
        for prec in (BF16, FLOAT32):
            ops = calls(kernel, name, batches, prec, dev)
            params = loaders.params_from_numpy(make(0), prec, dev)
            tag = f"# {args.label} {kernel} {name} {profile} W={w} {prec.compute_dtype}"
            try:
                fn(**ops[0])
            except ValueError as e:
                refused += 1
                print(f"{tag}: refused ({e})")
                continue
            ms = cuda_ms(lambda: [fn(**o) for o in ops], args.reps)
            path = cuda_ms(lambda: [forward(params, b, prec, return_intermediates=inter)
                                    for b in batches], args.reps)
            print(f"{tag}: {ms:.4f} ms per stream ({len(ops)} launches); its path "
                  f"{path * 1e3 / graphs:.4f} us/graph")
    return 1 if refused else 0


if __name__ == "__main__":
    sys.exit(main())
