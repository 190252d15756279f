"""Per-stage ablation of the GAT and DGN passes over the slot layout.

The counterpart of ``flowgnn_tpu.bench.ablate_slots``: each stage of the
pass over the first molhiv bucket in the degree-sorted slot layout, alone,
in ms per pass and µs per graph:

  both noop                                an empty CUDA graph replayed
  GAT  full model                          the forward (row 5 on a bucket
                                           with no spill tail)
       slot kernel xL (chained)            row 21 (``gat_local_message_slots``)
                                           once a layer, divided in the kernel
       glue xL (skip+ELU+proj+scores)      the per-layer path's glue
       embed (proj0 + scores)              layer 0's projection and scores
  DGN  full model                          the forward (row 4)
       slot layer xL (chained)             row 22 (``dgn_local_layer_slots``)
                                           once a layer
       aux (eig sums + degree)             the eigenvector sums and degrees
       embed + readout                     the atom embedding, the mean pool
                                           and the readout MLP

Each stage's launches are captured once in a CUDA graph and replayed
(``bench.stages``): nothing merges them, so a kernel stage launches layer
0's operands once a layer, where the JAX tool chains the layers behind a
carry so that XLA cannot merge them, and no floor is subtracted (noop
keeps the JAX tool's row, the replay of an empty graph). The window is the port's
(``models.base.GEOMETRY_DEFAULTS``: 128 for both, where the JAX tool takes
its TPU table's 384 for GAT; ``--window`` sets it). ``--check`` holds the
kernel stage's launch against its plain version once.

Run on the card: ``python -m flowgnn_tpu_torch.bench.ablate_slots --model
gat|dgn [--reps 100] [--trials 3] [--window W]``; on the CPU (the plain
versions, a host clock): ``--device cpu --graphs 16 --reps 1 --trials 1``.
"""

from __future__ import annotations

import argparse

from . import stages


def gat_stages(params: dict, batch: dict, prec, check: bool) -> list:
    """(label, key, fn) of GAT's stages on ``batch``."""
    import torch

    from ..models import gat
    from ..ops.local_layer import gat_local_message_slots, gat_local_message_slots_ref

    L = params["proj_w"].shape[0]
    ops = gat.layer_kernel_operands(params, batch, prec)["gat_local_message_slots"]
    if check:
        stages.check("slot kernel", gat_local_message_slots(**ops),
                     gat_local_message_slots_ref(**ops), prec.compute_dtype)
    h0 = gat._project(params["proj_w"][0], gat._raw_features(params, batch, prec), prec)

    def glue():
        prev = h0
        for l in range(L):
            msg = prev * 0.001
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

    return [
        (f"slot kernel x{L} (chained)", "kernel",
         lambda: [gat_local_message_slots(**ops) for _ in range(L)]),
        (f"glue x{L} (skip+ELU+proj+scores)", "glue", glue),
        ("embed (proj0 + scores)", "embed", embed),
    ]


def dgn_stages(params: dict, batch: dict, prec, check: bool) -> list:
    """(label, key, fn) of DGN's stages on ``batch``."""
    import torch

    from ..models import base, dgn
    from ..ops.local_layer import dgn_local_layer_slots, dgn_local_layer_slots_ref
    from ..ops.segment import segment_sum

    L = params["posttrans_w"].shape[0]
    ops = dgn.layer_kernel_operands(params, batch, prec)["dgn_local_layer_slots"]
    if check:
        stages.check("slot layer", dgn_local_layer_slots(**ops),
                     dgn_local_layer_slots_ref(**ops), prec.compute_dtype)
    dt = prec.compute_dtype
    u, v = batch["senders"].long(), batch["receivers"].long()
    n = base.num_nodes_static(batch)
    eig = batch["node_eigen"][:, 1].to(dt)

    def aux():
        ew = prec.q(eig[u] - eig[v])
        ea = segment_sum(ew.abs(), v, n)
        es = prec.q(segment_sum(ew, v, n))
        ea = prec.q(torch.where(ea == 0, dgn.EIG_EPS, ea))
        return ea, es, torch.clamp_min(base.out_degree(batch), 1).to(dt)

    def embed():
        h = dgn._atom_embed_dgn(params["atom_tables"], batch["node_feat"], prec)
        hg = base.mean_pool(h, batch, prec)
        z = base.relu(base.linear(hg, params["mlp1_w"], params["mlp1_b"], prec))
        z = base.relu(base.linear(z, params["mlp2_w"], params["mlp2_b"], prec))
        return base.linear(z, params["mlp3_w"], params["mlp3_b"], prec)

    return [
        (f"slot layer x{L} (chained)", "kernel",
         lambda: [dgn_local_layer_slots(**ops) for _ in range(L)]),
        ("aux (eig sums + degree)", "aux", aux),
        ("embed + readout", "embed", embed),
    ]


def main(argv=None) -> dict | None:
    from ..models import registry
    from .matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    stages.add_arguments(ap, reps=100)
    ap.add_argument("--model", default="gat", choices=["gat", "dgn"])
    ap.add_argument("--window", type=int, default=None)
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    prec = stages.precision(args)
    params = stages.load_params(args.model, args, prec, device)
    if params is None:
        return None
    batch = stages.molhiv_batches(args.model, args.graphs, "local_slots", args.window,
                                  device, node_capacity=args.node_cap)[0]
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    n_spill = int(batch["slot_spill"].shape[-1])
    n = int(batch["node_feat"].shape[0])
    print(f"geometry: window={window} slots={n_slots} spill={n_spill} nodes={n} "
          f"graphs={args.graphs}")
    forward = registry.get(args.model).forward
    split = (gat_stages if args.model == "gat" else dgn_stages)(params, batch, prec, args.check)
    rows = [("noop (empty graph replayed)", "noop", lambda: None),
            ("full model", "full", lambda: forward(params, batch, prec)), *split]
    times = {}
    for label, key, fn in rows:
        times[key] = stages.print_stage(
            label, stages.trial_seconds(fn, device, args.reps, args.trials), width=30,
            graphs=args.graphs)
    rec = stages.stage_record(f"{args.model}_slots_ablation_ms_per_pass", times,
                              labels={key: label for label, key, _ in rows}, window=window,
                              slots=n_slots, spill=n_spill, dtype=args.dtype)
    stages.print_record(rec)
    return rec


if __name__ == "__main__":
    main()
