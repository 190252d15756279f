"""Per-stage ablation of the GAT pass over the ELL layout (kernel table
row 17, ``ops.local_layer.gat_local_message_ell``).

The counterpart of ``flowgnn_tpu.bench.ablate_gat``: each stage of the GAT
layer over the first 32k-node molhiv bucket in the ELL layout, alone:

  noop    an empty CUDA graph replayed (the JAX tool's dispatch floor)
  full    the forward (row 17 and the glue each layer, unfused)
  kernel  row 17 once a layer (the attention numerators and denominators)
  spill   the window-crossing spill tail once a layer: its scores and scored
          sources, summed by row 24 (``ops.spmm.windowed_segment_sum``) where
          the JAX tool runs XLA's segment_sum; only where the layout
          spilled lanes (else the JAX tool's skip line)
  glue    the divide, skip projection, ELU, next projection and scores, once
          a layer
  embed   the input projection and the first scores

Each stage's launches are captured once in a CUDA graph and replayed
(``bench.stages``): nothing merges them, so a kernel stage launches layer
0's operands once a layer (the JAX tool chains the layers behind a carry
against XLA's merging), and the replay has no dispatch floor to subtract.
The window and block are the port's (``models.base.GEOMETRY_DEFAULTS``: 128
and 512, where the JAX tool takes its TPU table's 384 and 1536;
``--ell-window`` / ``--ell-block`` set them). ``--check`` holds row 17's
launch against its plain version once.

Run on the card: ``python -m flowgnn_tpu_torch.bench.ablate_gat [--reps 100]
[--trials 3] [--ell-window W] [--ell-block B]``; on the CPU (the plain
versions, a host clock): ``--device cpu --graphs 16 --reps 1 --trials 1``.
"""

from __future__ import annotations

import argparse

from . import stages


def main(argv=None) -> dict | None:
    import torch

    from ..models import base, gat, registry
    from ..ops.local_layer import gat_local_message_ell, gat_local_message_ell_ref
    from .matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    stages.add_arguments(ap, reps=100)
    ap.add_argument("--ell-window", type=int, default=None)
    ap.add_argument("--ell-block", type=int, default=None)
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    prec = stages.precision(args)
    params = stages.load_params("gat", args, prec, device)
    if params is None:
        return None
    batch = stages.molhiv_batches("gat", args.graphs, "local_ell", args.ell_window, device,
                                  block=args.ell_block, node_capacity=args.node_cap)[0]
    n = base.num_nodes_static(batch)
    L, H, D = params["proj_w"].shape[:3]
    lanes = int(batch["loc_ulocal"].shape[0])
    window, k_blocks = base.ell_geometry(batch)
    spill_lanes = base.ell_spill_lanes(batch)
    print(f"geometry: window={window} k_blocks={k_blocks} lanes={lanes} "
          f"spill_lanes={spill_lanes}")
    forward = registry.get("gat").forward
    h0 = gat._project(params["proj_w"][0], gat._raw_features(params, batch, prec), prec)
    s0 = gat._scores(h0, params["a_src"][0], prec), gat._scores(h0, params["a_tgt"][0], prec)
    ops = gat.ell_message_operands(h0, *s0, batch, base.ell_meta(batch))
    if args.check:
        stages.check("kernel", gat_local_message_ell(**ops), gat_local_message_ell_ref(**ops),
                     prec.compute_dtype)
    spill = gat.ell_spill_lanes(batch)
    fake_both = torch.ones(n, H * D + H, dtype=prec.compute_dtype, device=device)

    def glue():
        prev = h0
        for l in range(L):
            msg = fake_both[:, : H * D].reshape(n, H, D) + prev * 0.001
            denom = fake_both[:, H * D :]
            msg = prec.q(msg / torch.where(denom == 0, 1, denom)[:, :, None])
            skip = gat._project(params["skip_w"][l], prev, prec)
            if l != L - 1:
                feat = msg + skip
                feat = prec.q(torch.where(feat <= 0, torch.exp(feat) - 1, feat))
                prev = gat._project(params["proj_w"][l], feat, prec)
                gat._scores(prev, params["a_src"][l], prec)
            else:
                (msg + skip).sum(dim=1)

    def embed():
        h = gat._project(params["proj_w"][0], gat._raw_features(params, batch, prec), prec)
        return gat._scores(h, params["a_src"][0], prec), gat._scores(h, params["a_tgt"][0], prec)

    rows = [
        ("noop (empty graph replayed)", "noop", lambda: None),
        ("full model", "full", lambda: forward(params, batch, prec, fuse_layers=False)),
        (f"kernel x{L} (chained)", "kernel",
         lambda: [gat_local_message_ell(**ops) for _ in range(L)]),
    ]
    if spill is not None:
        tail = lambda: base.ell_spill_segment_sum(gat.spill_values(h0, *s0, *spill), batch)
        rows.append((f"spill tail x{L} ({spill_lanes} lanes)", "spill",
                     lambda: [tail() for _ in range(L)]))
    rows += [(f"glue x{L} (chained)", "glue", glue), ("embed (proj0 + scores)", "embed", embed)]
    times = {}
    for label, key, fn in rows:
        times[key] = stages.print_stage(
            label, stages.trial_seconds(fn, device, args.reps, args.trials))
        if key == "kernel" and spill is None:
            print(f"spill tail x{L}                   (no spill lanes — skipped)")
    rec = stages.stage_record("gat_ell_ablation_ms_per_pass", times,
                              labels={key: label for label, key, _ in rows}, window=window,
                              k_blocks=k_blocks, lanes=lanes, spill_lanes=spill_lanes,
                              dtype=args.dtype)
    stages.print_record(rec)
    return rec


if __name__ == "__main__":
    main()
