"""The whole-model kernels, their one-layer forms and the per-layer slot
kernels of PNA and GAT on their cells: rows 3 (``pna_local_model``), 4
(``dgn_local_model``) and 2 (``gcn_local_model_slots``) over slots, rows 8
(``gin_local_model``) and 9 (``gcn_local_model``) over ELL, rows 20
(``pna_local_layer``) and 22 (``dgn_local_layer_slots``), the one-layer forms
of rows 3 and 4, row 19 (``pna_local_stats_ell``, row 3's stats-only form)
row 21 (``gat_local_message_slots``) and row 5 (``gat_local_model_slots``),
alone in ms per stream and as the model's forward over the stream in µs per
graph, bf16 and f32; and each form's ``full`` of the GAT megakernel
ablation (rows 27-30, ``bench.ablate_gat_mega.gat_mega_ablate``: row 5's
body in four forms) on the ablation tool's bucket, alone.

    python -m flowgnn_tpu_torch.bench.slot_kernels --label change

The cells are the streams ``chip_smoke.py`` times them on: the 4113-graph
synthetic molhiv stream in slots (W=128; rows 3, 4 and 2 once per bucket, row
20 once per layer and bucket, the stream run with intermediates), the
2048-graph hep10k sample in slots at W=512 (rows 3, 4 and 2 once per bucket,
rows 20 and 22 once per layer and bucket) and at W=128, where it spills
(row 22 once per layer and bucket, with the tail's channels; row 19 once
per layer and bucket, PNA's spill path); rows 8 and 9
on the hep10k sample and the molhiv stream in ELL at the window
``choose_geometry`` gives (once per bucket); row 21 on the hep10k sample in
slots at W=128, where it spills (the raw sums, once per layer and bucket),
and on the molhiv stream in slots run with intermediates (divided in the
kernel, once per layer and bucket); row 5 on the molhiv stream in slots
(W=128) and the hep10k sample in slots at W=512, once per bucket; rows
27-30 on the ablation tool's 1028-graph molhiv bucket at its default window
(W=128), one launch; with seeded synthetic weights. A per-layer kernel is
timed on each bucket's layer-0 operands, once per layer, as
``chip_smoke.py`` does; the forward is the path that runs the kernel
(``return_intermediates`` on the cells of rows 20, 22 and 21 with no spill
tail). Each (kernel, cell, dtype) is timed with CUDA
events (3 warm-up passes, the mean of ``--reps``) and printed with the
launches per stream, and the kernel also as its launches replayed from a
CUDA graph (``bench.timing``: the device time, the wrappers' host work left
out); a cell whose geometry a kernel refuses is printed as
refused with the wrapper's message, and the tool then exits 1. It uses
only the models' operand functions and the wrappers, so it times another
revision of the package as well: run it from that revision's checkout, in
turns with this one, to compare the two on one card. The card's name and
power limit are printed first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

from .layer_kernels import stream
from .timing import cuda_ms, graph_ms, replay_ms

SLOTS, ELL = "local_slots", "local_ell"
# (kernel, model, profile, graphs, layout, window; None: choose_geometry's).
CELLS = (
    ("pna_local_model", "pna", "molhiv", 4113, SLOTS, None),
    ("pna_local_model", "pna", "hep10k", 2048, SLOTS, 512),
    ("dgn_local_model", "dgn", "molhiv", 4113, SLOTS, None),
    ("dgn_local_model", "dgn", "hep10k", 2048, SLOTS, 512),
    ("pna_local_layer", "pna", "molhiv", 4113, SLOTS, None),
    ("pna_local_layer", "pna", "hep10k", 2048, SLOTS, 512),
    ("dgn_local_layer_slots", "dgn", "hep10k", 2048, SLOTS, 128),
    ("dgn_local_layer_slots", "dgn", "hep10k", 2048, SLOTS, 512),
    ("gin_local_model", "gin", "hep10k", 2048, ELL, None),
    ("gin_local_model", "gin", "molhiv", 4113, ELL, None),
    ("gcn_local_model", "gcn", "hep10k", 2048, ELL, None),
    ("gcn_local_model", "gcn", "molhiv", 4113, ELL, None),
    ("gcn_local_model_slots", "gcn", "molhiv", 4113, SLOTS, None),
    ("gcn_local_model_slots", "gcn", "hep10k", 2048, SLOTS, 512),
    ("gat_local_message_slots", "gat", "hep10k", 2048, SLOTS, 128),
    ("gat_local_message_slots", "gat", "molhiv", 4113, SLOTS, None),
    ("pna_local_stats_ell", "pna", "hep10k", 2048, SLOTS, 128),
    ("gat_local_model_slots", "gat", "molhiv", 4113, SLOTS, None),
    ("gat_local_model_slots", "gat", "hep10k", 2048, SLOTS, 512),
)
ABLATION = "gat_mega_ablate"  # rows 27-30: each form's full on the tool's bucket
ABLATION_GRAPHS = 1028
LAYER_KERNELS = ("pna_local_layer", "dgn_local_layer_slots", "gat_local_message_slots",
                 "pna_local_stats_ell")
# Each model's weight whose leading axis counts its layers.
LAYER_WEIGHT = {"pna": "conv_w", "dgn": "posttrans_w", "gat": "proj_w"}


def params_of(name: str, prec, device) -> dict:
    """``name``'s seeded synthetic weights in ``prec`` on ``device``."""
    from flowgnn_tpu_torch.params import loaders

    make = getattr(loaders, f"synthetic_{name}_params")
    return loaders.params_from_numpy(make(0), prec, device)


def calls(kernel: str, name: str, batches: list, layout: str, prec, device) -> list:
    """The keyword operands of every launch of ``kernel`` over the stream:
    a whole-model kernel's per bucket, a per-layer kernel's layer-0 operands
    per bucket, once per layer."""
    from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna

    mod = {"pna": pna, "dgn": dgn, "gin": gin, "gcn": gcn, "gat": gat}[name]
    params = params_of(name, prec, device)
    if layout == ELL:
        return [mod.ell_kernel_operands(params, b, prec) for b in batches]
    if kernel not in LAYER_KERNELS:
        return [mod.slot_kernel_operands(params, b, prec) for b in batches]
    layers = params[LAYER_WEIGHT[name]].shape[0]
    return [mod.layer_kernel_operands(params, b, prec)[kernel] for b in batches
            for _ in range(layers)]


def main(argv=None) -> int:
    import torch

    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import base, registry
    from flowgnn_tpu_torch.ops import local_layer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="current", help="the revision's name in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="",
                    help="only these comma-separated kernels (default: every cell's and "
                         f"{ABLATION})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slot_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    from flowgnn_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_libraries(local_layer.LIBRARIES)  # in parallel, before the first launch
    only = {k for k in args.kernels.split(",") if k}
    streams, refused = {}, 0
    for kernel, name, profile, graphs, layout, window in CELLS:
        if only and kernel not in only:
            continue
        key = (name, profile, graphs, layout, window)
        if key not in streams:
            streams[key] = stream(name, profile, graphs, layout, window, dev)
        batches = streams[key]
        w = (base.ell_geometry(batches[0])[0] if layout == ELL
             else int(batches[0]["slot_geom"].shape[0]))
        fn = getattr(local_layer, kernel)
        # The forward that runs the kernel: a no-spill bucket reaches rows 20,
        # 22 and 21 with intermediates only (row 19 a spilling one only).
        inter = kernel in LAYER_KERNELS and not batches[0]["slot_spill"].shape[-1]
        forward = registry.get(name).forward
        for prec in (BF16, FLOAT32):
            ops = calls(kernel, name, batches, layout, prec, dev)
            params = params_of(name, prec, dev)
            tag = f"# {args.label} {kernel} {name} {profile} {layout} W={w} {prec.compute_dtype}"
            try:
                fn(**ops[0])
            except ValueError as e:
                refused += 1
                print(f"{tag}: refused ({e})")
                continue
            ms = cuda_ms(lambda: [fn(**o) for o in ops], args.reps)
            replay = graph_ms(lambda: [fn(**o) for o in ops], args.reps)
            path = cuda_ms(lambda: [forward(params, b, prec, return_intermediates=inter)
                                    for b in batches], args.reps)
            print(f"{tag}: {replay:.4f} ms per stream by graph replay, {ms:.4f} by the loop "
                  f"({len(ops)} launches); its path {path * 1e3 / graphs:.4f} us/graph")
    if not only or ABLATION in only:
        refused += time_ablation(args.label, args.reps, dev)
    return 1 if refused else 0


def time_ablation(label: str, reps: int, dev) -> int:
    """Each form's ``full`` of rows 27-30 on the ablation tool's bucket, bf16
    and f32, by graph replay, by the loop and one replay at a time (the
    spread, and the first and last of ``reps`` replays, for drift); returns
    the forms refused."""
    from flowgnn_tpu_torch.bench import ablate_gat_mega as abl
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.ops import build

    build.build_libraries(abl.LIBRARIES)
    batch = abl.molhiv_bucket(ABLATION_GRAPHS, None, dev)
    w = int(batch["slot_geom"].shape[0])
    refused = 0
    for prec in (BF16, FLOAT32):
        c = abl.ablation_operands(params_of("gat", prec, dev), batch, prec)
        for form in abl.FORMS:
            ops = abl.form_operands(form, c)
            tag = (f"# {label} {ABLATION} {form} full gat molhiv-{ABLATION_GRAPHS} W={w} "
                   f"{prec.compute_dtype}")
            fn = lambda: abl.gat_mega_ablate(form, "full", **ops)
            try:
                fn()
            except ValueError as e:
                refused += 1
                print(f"{tag}: refused ({e})")
                continue
            replay, loop, one = graph_ms(fn, reps), cuda_ms(fn, reps), replay_ms(fn, reps)
            low, mid, high = min(one), statistics.median(one), max(one)
            print(f"{tag}: {replay:.4f} ms by graph replay, {loop:.4f} by the loop (1 launch); "
                  f"one replay at a time {low:.4f} / {mid:.4f} / {high:.4f} (min / median / max "
                  f"of {reps}), first {one[0]:.4f}, last {one[-1]:.4f}")
    return refused


if __name__ == "__main__":
    sys.exit(main())
