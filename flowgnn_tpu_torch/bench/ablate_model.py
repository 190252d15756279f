"""Per-stage ablation of the GIN / GIN-VN whole-model pass (kernel table
row 8, ``ops.local_layer.gin_local_model``).

The counterpart of ``flowgnn_tpu.bench.ablate_model``: each stage of the
pass over the first 32k-node molhiv bucket in the k=1 ELL layout, alone:

  noop    an empty CUDA graph replayed (the JAX tool's dispatch floor)
  full    the complete forward (embed + row 8 + readout)
  mega    row 8 alone, all layers
  embed   the atom embedding alone
  pool    the mean pool and the prediction head alone

The JAX tool chains each stage's iterations behind a scalar carry so XLA
cannot merge them, and subtracts the noop row. Here each stage's launches
are captured once in a CUDA graph and replayed: nothing merges them, and
the replay has no dispatch floor to subtract, so noop reads the replay of
an empty graph only (``bench.stages``). The window and block are the
port's (``models.base.GEOMETRY_DEFAULTS``: 128 and 384 for both models,
where the JAX tool takes GIN-VN at 256 and 640); a bucket that is not k=1
without spill lanes (row 8's) stops the tool, as the JAX tool asserts.
``--check`` holds row 8's launch against its plain version once.

Run on the card: ``python -m flowgnn_tpu_torch.bench.ablate_model [--model
gin|gin-vn] [--reps 100] [--trials 3]``; on the CPU (the plain versions, a
host clock): ``--device cpu --graphs 16 --reps 1 --trials 1``.
"""

from __future__ import annotations

import argparse

from . import stages


def main(argv=None) -> dict | None:
    from ..models import base, gin, registry
    from ..ops.local_layer import gin_local_model, gin_local_model_ref
    from .matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    stages.add_arguments(ap, reps=100)
    ap.add_argument("--model", default="gin", choices=["gin", "gin-vn"])
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    prec = stages.precision(args)
    params = stages.load_params(args.model, args, prec, device)
    if params is None:
        return None
    batch = stages.molhiv_batches(args.model, args.graphs, "local_ell", None, device,
                                  edge_capacity=None, node_capacity=args.node_cap)[0]
    window, k_blocks = base.ell_geometry(batch)
    lanes = int(batch["loc_ulocal"].shape[0])
    spill = base.ell_spill_lanes(batch)
    print(f"geometry: window={window} k_blocks={k_blocks} lanes={lanes} spill_lanes={spill}")
    if not base.ell_megakernel(batch, False):
        raise SystemExit("ablate_model: the megakernel path requires k=1 and no spill lanes")
    forward = registry.get(args.model).forward
    ops = gin.ell_kernel_operands(params, batch, prec)
    if args.check:
        stages.check("mega", gin_local_model(**ops), gin_local_model_ref(**ops),
                     prec.compute_dtype)
    h0 = base.atom_embed(params["node_embedding"], batch["node_feat"], prec)

    def pool():
        hg = base.mean_pool(h0, batch, prec)
        return base.linear(hg, params["pred_w"], params["pred_b"], prec)

    rows = (
        ("noop (empty graph replayed)", "noop", lambda: None),
        ("full model", "full", lambda: forward(params, batch, prec)),
        ("megakernel (all layers)", "mega", lambda: gin_local_model(**ops)),
        ("embed (atom multi-hot)", "embed",
         lambda: base.atom_embed(params["node_embedding"], batch["node_feat"], prec)),
        ("pool + pred head", "pool", pool),
    )
    times = {}
    for label, key, fn in rows:
        times[key] = stages.print_stage(
            label, stages.trial_seconds(fn, device, args.reps, args.trials))
    rec = stages.stage_record(f"{args.model.replace('-', '_')}_model_ablation_ms_per_pass",
                              times, window=window, lanes=lanes, dtype=args.dtype)
    stages.print_record(rec)
    return rec


if __name__ == "__main__":
    main()
