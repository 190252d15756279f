"""Time attribution inside the GAT megakernel (kernel table row 5).

The counterpart of ``flowgnn_tpu.bench.ablate_gat_pairs``, which stubs one
stage at a time of the TPU pairs kernel (``gat_local_model_pairs(_ablate=...)``)
and prints the same JSON record as here. The port's row 5
(``csrc/gat_model.cuh``, form Row5) compiles its knockouts out, so the
stubs run on the ablation library's row-5 form (``r5`` of
``bench.ablate_gat_mega``: the same body and operands with the stubs read):

  full      row 5's function
  nogather  lane i's source is row i mod W (the TPU stub's tiny gather over
            the window's first 8 rows has no meaning for a gather by index)
  noscore   no score map and no exp: every valid lane's score is 1
  noglue    no glue product between layers: h = feat, skip kept
  noacc     row r takes the window's lane r alone, its denominator score + 1
  a:b:...   those together

``noonehot`` (the TPU stub of the two-hot gather operand's build) is
refused: the Hopper kernel gathers by index and builds no one-hot, so there
is no stage to knock out. Each variant's plain version is
``gat_mega_ablate_ref("r5", ...)``, which ``--check`` holds each launch
against; (full − variant) is the stage's device time per pass.

The record also carries the gather's in-situ factor, as the JAX tool's
docstring describes it: ``attrib_nogather_us`` over the time of
``bench.matmul_shapes``' "gat pairs two-hot" row (timed here on
``chained_matmul``, row 26) scaled to this bucket's two-hot product, the
TPU's gather ([Σc, 2W] @ [2W, 2·H·D] per window pair and layer). The Hopper
kernel runs no such product, so the factor compares the stage with what the
tensor cores would take for the TPU's formulation; the record says where
the shape table has no such row.

Shared method, options and the lack of a floor: ``bench.stages``. Run on
the card: ``python -m flowgnn_tpu_torch.bench.ablate_gat_pairs [--reps 200]``;
on the CPU: ``--device cpu --graphs 16 --reps 1 --trials 1``.
"""

from __future__ import annotations

import argparse

from . import stages

DEFAULT_VARIANTS = "full,nogather,noscore,noglue,noacc,nogather:noscore:noglue"
GATHER_SHAPE = "gat pairs two-hot"


def gather_factor(attrib_s: float, batch: dict, hd: int, layers: int, reps: int,
                  trials: int, device) -> dict:
    """The in-situ factor of the gather: ``attrib_s`` over the shape row's
    time scaled by this bucket's two-hot FLOPs, or the record's note that
    the shape table has no such row."""
    from .matmul_shapes import SHAPES, measure

    row = next((s for s in SHAPES if s[0].startswith(GATHER_SHAPE)), None)
    if row is None:
        return {"gather_in_situ_factor": None,
                "gather_shape": f"absent: bench.matmul_shapes has no {GATHER_SHAPE!r} row"}
    label, m, k, n, shape_layers, grid, dtype = row
    window, _ = (int(x) for x in batch["slot_geom"].shape[-2:])
    lanes = int(batch["slot_pstack"].shape[0])  # Σc lanes of every window
    windows = -(-int(batch["node_feat"].shape[0]) // window)
    # Per pair of windows and layer: [Σc, 2W] @ [2W, 2HD].
    stream_flops = 2.0 * (lanes // windows) * 2 * window * 2 * hd * layers * (windows / 2)
    shape_flops = 2.0 * m * k * n * shape_layers * grid
    shape_s = measure(m, k, n, shape_layers, grid, dtype, reps, trials, device)
    scaled = shape_s * stream_flops / shape_flops
    return {"gather_shape": label, "gather_shape_us": scaled * 1e6,
            "gather_in_situ_factor": attrib_s / scaled if scaled > 0 else None}


def main(argv=None) -> dict | None:
    import torch

    from ..models import gat
    from .ablate_gat_mega import (gat_mega_ablate, gat_mega_ablate_ref, molhiv_bucket,
                                  row5_operands)
    from .matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    stages.add_arguments(ap, reps=200)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    if any("noonehot" in v.split(":") for v in variants):
        raise SystemExit("ablate_gat_pairs: noonehot stubs the TPU kernel's two-hot operand "
                         "build; the Hopper kernel gathers by index and builds no one-hot, so "
                         "there is no stage to knock out")
    device = tool_device(args.device)
    prec = stages.precision(args)
    params = stages.load_params("gat", args, prec, device)
    if params is None:
        return None
    batch = molhiv_bucket(args.graphs, None, device, args.node_cap)
    k = gat.slot_kernel_operands(params, batch, prec)
    ops = row5_operands(k)
    stubs = {v: "full" if v == "full" else v.replace(":", ",") for v in variants}
    print(f"# window {k['window']} slots {k['slots']} prefix {k['prefix_caps']} buckets 1 "
          f"{prec.compute_dtype}")
    seconds = stages.timer(device, args.reps, args.trials)
    results = {}
    for v, stub in stubs.items():
        if args.check:
            stages.check(v, gat_mega_ablate("r5", stub, **ops),
                         gat_mega_ablate_ref("r5", stub, **ops), prec.compute_dtype)
        results[v] = seconds(lambda stub=stub: gat_mega_ablate("r5", stub, **ops))
        print(f"# {v}: {results[v] * 1e6:.3f} us/pass")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = stages.variant_record("gat_pairs_ablation_us_per_pass", results)
    if "full" in results and "nogather" in results:
        rec.update(gather_factor(results["full"] - results["nogather"], batch,
                                 int(k["h0"].shape[1]), k["num_layers"], args.reps, args.trials,
                                 device))
    stages.print_record(rec)
    return rec


if __name__ == "__main__":
    main()
