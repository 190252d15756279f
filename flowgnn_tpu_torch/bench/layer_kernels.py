"""The per-layer GIN, GAT, DGN and GCN kernels and the windowed scatter on
their cells: rows 13 (``gin_local_layer_ell``), 10 (``gin_local_layer``), 12
(``gin_local_layer_ell_lanes``), 25 (``gin_layer_fused``), 23
(``gat_local_layer_ell``), 17 (``gat_local_message_ell``), 18
(``dgn_local_layer_ell``), 16 (``dgn_local_message_ell``), 15
(``gcn_local_layer_ell``), 14 (``gcn_local_message_ell``) and 24
(``windowed_segment_sum``), each alone in ms per stream, bf16 and f32.

    python -m flowgnn_tpu_torch.bench.layer_kernels --label change

The cells are the streams ``chip_smoke.py`` times them on, with seeded
synthetic weights at the models' widths: row 13 on the 2048-graph hep10k
sample in ELL at W=128 (block 384, a spill tail) and on the 4113-graph
synthetic molhiv stream in ELL (the intermediates cell); row 10 on molhiv in
the legacy local layout (GIN and GIN-VN); row 12 on molhiv in ELL with each
lane's bond embedding given; row 25 on molhiv in the edge-block layout
(unaligned packing); rows 23 and 17 on the hep10k sample and on molhiv in
ELL (W=128, block 512); row 18 on molhiv in ELL (W=128, block 512); row 16
on the hep10k sample in ELL at W=128 (block 512, a spill tail); row 15 on
molhiv in ELL (the intermediates cell: no spill tail); row 14 on GCN's hep10k
sample in ELL at W=128 (block 384, a spill tail); row 24 on each path that
runs it: the slot spill tails of PNA and GAT (hep10k at W=128), the ELL spill
tails of GCN, GAT and DGN (hep10k at W=128) and the edge-block layout of GIN,
GAT, PNA and DGN on molhiv (widths 100, 68, 160, 200). Each
launch runs a bucket's layer-0 operands, once per layer (row 23: every layer
but the last), as ``chip_smoke.py`` times them. Each (kernel, cell, dtype) is
timed with CUDA events (3 warm-up passes, the mean of ``--reps``) twice: as a
Python loop of wrapper calls, which times the wrappers' host work once a
launch needs less device time than that, and as the same launches replayed
from a CUDA graph, their device time (``bench.timing``); printed with the
launches per stream. ``--kernels`` keeps the cells of the kernels it
names. It uses
only the models' operand functions and the wrappers, so it times another
revision of the package as well (with this package's ``bench/timing.py``
beside it): run it from that revision's checkout, in turns with this one, to
compare the two on one card. The card's name and power limit are printed
first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from .timing import cuda_ms, graph_ms

NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
# (kernel, model, profile, graphs, layout, window; None: choose_geometry's).
CELLS = (
    ("gin_local_layer_ell", "gin", "hep10k", 2048, "local_ell", 128),
    ("gin_local_layer_ell", "gin", "molhiv", 4113, "local_ell", None),
    ("gin_local_layer", "gin", "molhiv", 4113, "local", None),
    ("gin_local_layer", "gin-vn", "molhiv", 4113, "local", None),
    ("gin_local_layer_ell_lanes", "gin", "molhiv", 4113, "local_ell", None),
    ("gin_layer_fused", "gin", "molhiv", 4113, True, None),
    ("gat_local_layer_ell", "gat", "hep10k", 2048, "local_ell", 128),
    ("gat_local_layer_ell", "gat", "molhiv", 4113, "local_ell", None),
    ("gat_local_message_ell", "gat", "hep10k", 2048, "local_ell", 128),
    ("gat_local_message_ell", "gat", "molhiv", 4113, "local_ell", None),
    ("dgn_local_layer_ell", "dgn", "molhiv", 4113, "local_ell", None),
    ("dgn_local_message_ell", "dgn", "hep10k", 2048, "local_ell", 128),
    ("gcn_local_layer_ell", "gcn", "molhiv", 4113, "local_ell", None),
    ("gcn_local_message_ell", "gcn", "hep10k", 2048, "local_ell", 128),
    ("windowed_segment_sum", "pna", "hep10k", 2048, "local_slots", 128),
    ("windowed_segment_sum", "gcn", "hep10k", 2048, "local_ell", 128),
    ("windowed_segment_sum", "gin", "molhiv", 4113, True, None),
    ("windowed_segment_sum", "gat", "hep10k", 2048, "local_ell", 128),
    ("windowed_segment_sum", "dgn", "hep10k", 2048, "local_ell", 128),
    ("windowed_segment_sum", "gat", "hep10k", 2048, "local_slots", 128),
    ("windowed_segment_sum", "gat", "molhiv", 4113, True, None),
    ("windowed_segment_sum", "pna", "molhiv", 4113, True, None),
    ("windowed_segment_sum", "dgn", "molhiv", 4113, True, None),
)
# Each model's weight whose leading axis counts its layers.
LAYER_WEIGHT = {"gin": "mlp1_w", "gcn": "conv_w", "pna": "conv_w", "dgn": "posttrans_w",
                "gat": "proj_w"}


def stream(name: str, profile: str, graphs: int, layout, window, device) -> list:
    """The batches of ``name``'s stream of ``profile`` in ``layout`` at
    ``window`` (None: the window ``choose_geometry`` gives its largest
    graph; the ELL block scaled to it), on ``device``; the edge-block layout
    (``layout`` True) packs without window alignment."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, registry

    spec = registry.get(name)
    gs = registry.apply_transforms(spec, synthetic_dataset(profile, seed=0, num_graphs=graphs))
    window, block = base.choose_geometry(name, window or max(g.num_nodes for g in gs))
    buckets = list(pack_dataset(gs, node_capacity=NODE_CAP,
                                edge_capacity=auto_edge_capacity(gs, NODE_CAP),
                                graph_capacity=GRAPH_CAP, with_eigen=spec.needs_eigen,
                                align_window=None if layout is True else window))
    return [base.to_device(b, device)
            for b in base.as_batches_uniform(buckets, blocked=layout, window=window, block=block)]


def calls(kernel: str, name: str, batches: list, prec, device) -> list:
    """The keyword operands of every launch of ``kernel`` over the stream:
    each bucket's layer-0 operands, once per layer that runs the kernel (row
    17 on GAT's unfused path: every layer; row 24 on every layer of a path
    with a spill tail or of the edge-block layout)."""
    from flowgnn_tpu_torch.models import base, dgn, gat, gcn, gin, pna
    from flowgnn_tpu_torch.params import loaders

    family = name.split("-")[0]  # GIN-VN runs GIN's weights
    make = getattr(loaders, f"synthetic_{family}_params")
    params = loaders.params_from_numpy(make(0), prec, device)
    layers = params[LAYER_WEIGHT[family]].shape[0]
    if name == "gat":
        fuse = kernel == "gat_local_layer_ell"
        layers -= fuse
        ops = [gat.layer_kernel_operands(params, b, prec, fuse_layers=fuse)[kernel]
               for b in batches]
    elif name in ("dgn", "gcn", "pna"):
        mod = {"dgn": dgn, "gcn": gcn, "pna": pna}[name]
        ops = [mod.layer_kernel_operands(params, b, prec)[kernel] for b in batches]
    else:
        if kernel == "gin_local_layer_ell_lanes":
            ops = []
            for b in batches:
                h = base.atom_embed(params["node_embedding"], b["node_feat"], prec)
                o = gin.ell_layer_operands(params, b, prec, 0, h, base.ell_meta(b),
                                           base.ell_spill(b), gin.eps1_all(params, prec),
                                           lane_ee=True)
                ops.append({k: v for k, v in o.items() if k != "ee_table"})
        else:
            ops = [gin.layer_kernel_operands(params, b, prec, fused=kernel == "gin_layer_fused")
                   [kernel] for b in batches]
    return [o for o in ops for _ in range(layers)]


def main(argv=None) -> int:
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.ops import build, fused_layer, local_layer, spmm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="current", help="the revision's name in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="",
                    help="only these comma-separated kernels (default: every cell's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("layer_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_libraries(local_layer.LIBRARIES)  # in parallel, before the first launch
    only = {k for k in args.kernels.split(",") if k}
    cells = [c for c in CELLS if not only or c[0] in only]
    streams = {}
    for kernel, name, profile, graphs, layout, window in cells:
        key = (name, profile, graphs, layout, window)
        if key not in streams:
            streams[key] = stream(name, profile, graphs, layout, window, dev)
        batches = streams[key]
        mod = {"gin_layer_fused": fused_layer, "windowed_segment_sum": spmm}.get(kernel,
                                                                                local_layer)
        fn = getattr(mod, kernel)
        for prec in (BF16, FLOAT32):
            ops = calls(kernel, name, batches, prec, dev)
            loop = cuda_ms(lambda: [fn(**o) for o in ops], args.reps)
            replay = graph_ms(lambda: [fn(**o) for o in ops], args.reps)
            print(f"# {args.label} {kernel} {name} {profile} {layout} {prec.compute_dtype}: "
                  f"{replay:.4f} ms per stream by graph replay, {loop:.4f} by the loop "
                  f"({len(ops)} launches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
