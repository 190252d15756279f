"""Time attribution inside the GIN slot megakernel (kernel table row 1).

The counterpart of ``flowgnn_tpu.bench.ablate_gin_slots``: the same stage
stubs, the same variants and the same JSON record, on the port's row 1
(``ops.local_layer.gin_local_model_slots``, ``csrc/gin_model.cuh``). Each
variant launches the kernel with stages knocked out (``knockout``, the bits
of ``ops.local_layer.GIN_KNOCKOUTS``) over every bucket of the molhiv pass:

  full      nothing knocked out (the ``ablation`` bit)
  nogather  a lane's source is h[u] only for u in the window's first 8 rows
  nobond    a lane's ee is the layer's bond-table row 0 where its first bond
            row is 0 (the count of its bond rows that are 0, times that row)
  noacc     row r takes the message of the window's lane r alone
  nomlp     no update MLP (and no weight ring): h = act
  a:b:...   those together

The stubs compute another function than the model (each has its plain
version, ``gin_local_model_slots_ref(knockout=...)``, which ``--check``
holds the launches against). The production kernel compiles the knockouts
out; every variant, ``full`` too, runs the kernel that reads them, so the
JAX tool's ``attrib_<variant>_us`` = full − variant is the stage's device
time per pass within one kernel. The record adds ``production_us``, the
production kernel (knockout 0) over the same pass. Shared method, options
and the lack of a floor: ``bench.stages``. Beside the JAX tool's options:
``--window`` (default ``choose_geometry``'s, 128 on molhiv), ``--dtype``
(bf16, the JAX tool's, or f32) and ``--device``.

Run on the card: ``python -m flowgnn_tpu_torch.bench.ablate_gin_slots [--reps
200] [--variants full,nogather,...]``; on the CPU (the plain versions, a
host clock): ``--device cpu --graphs 16 --reps 1 --trials 1``.
"""

from __future__ import annotations

import argparse

from . import stages

DEFAULT_VARIANTS = "full,nogather,nobond,noacc,nomlp,nogather:nobond:noacc:nomlp"


def knockout_of(variant: str) -> int:
    """The knockout bits of a ``--variants`` entry, with the ``ablation``
    bit that selects the kernel reading them (``full``: that bit alone)."""
    from ..ops.local_layer import GIN_KNOCKOUTS

    if variant == "full":
        return GIN_KNOCKOUTS["ablation"]
    stubs = variant.split(":")
    unknown = [s for s in stubs if s not in GIN_KNOCKOUTS or s in ("nomessages", "ablation")]
    if unknown:
        raise SystemExit(f"ablate_gin_slots: no stage stub {unknown[0]!r} (the stubs: nogather, "
                         "nobond, noacc, nomlp, joined by ':')")
    return GIN_KNOCKOUTS["ablation"] | sum(GIN_KNOCKOUTS[s] for s in set(stubs))


def main(argv=None) -> dict | None:
    import torch

    from ..models import gin
    from ..ops.local_layer import gin_local_model_slots, gin_local_model_slots_ref
    from .matmul_shapes import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    stages.add_arguments(ap, reps=200)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--window", type=int, default=None)
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    knockouts = {v: knockout_of(v) for v in variants}
    device = tool_device(args.device)
    prec = stages.precision(args)
    params = stages.load_params("gin", args, prec, device)
    if params is None:
        return None
    batches = stages.molhiv_batches("gin", args.graphs, "local_slots", args.window, device,
                                    node_capacity=args.node_cap)
    ops = [gin.slot_kernel_operands(params, b, prec) for b in batches]
    window, n_slots = (int(x) for x in batches[0]["slot_geom"].shape[-2:])
    print(f"# window {window} slots {n_slots} prefix {ops[0]['prefix_caps']} "
          f"buckets {len(batches)} gin {prec.compute_dtype}")
    seconds = stages.timer(device, args.reps, args.trials)
    results = {}
    for v, ko in knockouts.items():
        one_pass = lambda ko=ko: [gin_local_model_slots(**o, knockout=ko) for o in ops]
        if args.check:
            for i, o in enumerate(ops):
                want = gin_local_model_slots_ref(**o, knockout=ko)
                stages.check(f"{v} bucket {i}", gin_local_model_slots(**o, knockout=ko), want,
                             prec.compute_dtype)
        results[v] = seconds(one_pass)
        print(f"# {v}: {results[v] * 1e6:.3f} us/pass")
    production = seconds(lambda: [gin_local_model_slots(**o) for o in ops])
    print(f"# the production kernel: {production * 1e6:.3f} us/pass")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = stages.variant_record("gin_slots_ablation_us_per_pass", results)
    rec["production_us"] = production * 1e6
    stages.print_record(rec)
    return rec


if __name__ == "__main__":
    main()
