"""Row 8's float32 form (``csrc/gin_local_model.cu``, its FMA instantiation)
built from other revisions' sources, timed beside the current build on the
same streams, in turns.

    git show 5cf3c54:flowgnn_tpu_torch/csrc/gin_local_model.cu > flowgnn_tpu_torch/_build/pr8.cu
    python -m flowgnn_tpu_torch.bench.gin_ell_sources --source pr8=flowgnn_tpu_torch/_build/pr8.cu

Each ``--source LABEL=PATH`` is compiled with the port's flags
(``ops.build.NVCC_FLAGS``; the headers it includes are found beside it,
then in ``csrc/``) into the build directory, and its compiler report
(registers, spills) printed, with the instruction mix of its float32 kernel
(``cuobjdump -sass``: the most frequent opcodes) beside the current
build's. Its
C interface is read off its symbols: the current one (``gin_ell_mlp_dims``),
the one of the wgmma form's first revision (``gin_ell_tiles``: 14 pointers,
float32 passes null weight tiles) or the FMA-only one before it (12
pointers). On the GIN hep10k ELL W=512 stream (2048 graphs) and the GIN
molhiv ELL stream (4113 graphs), float32, seeded synthetic weights, each
build's output is held to the current kernel's (1e-4 of its scale), and each
build is timed in ms per stream with CUDA events, in turns: the current
kernel, each source, each source in reverse order, the current kernel. The
card's name and power limit are printed first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

NODE_CAP, GRAPH_CAP = 32768, 2048  # the JAX bench's bucket capacities
CELLS = (("hep10k", 2048), ("molhiv", 4113))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(label: str, path: Path) -> Path:
    """``path`` compiled into the build directory; prints its register
    report and returns the library."""
    from flowgnn_tpu_torch.ops import build as b

    src = path.read_bytes()
    digest = hashlib.sha256(src + "\0".join(b.NVCC_FLAGS).encode()).hexdigest()[:16]
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = b.BUILD_DIR / f"source-{label}-{digest}.so"
    if not so.exists():
        out = subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC_DIR), "-o", str(so),
                              str(path)], capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
        for line in (out.stdout + out.stderr).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"# {label}: {line.strip()[:160]}")
    return so


def f32_opcodes(so: Path, top: int = 14) -> str:
    """The most frequent opcodes of the float32 kernel (the one function
    whose mangled name holds ``kernelIf``) in a library's SASS, and the
    total."""
    import collections
    import re

    from flowgnn_tpu_torch.ops import build as b

    cuobjdump = str(Path(b.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "kernelIf" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return f"{sum(counts.values())} instructions: " + ", ".join(
        f"{op} {n}" for op, n in counts.most_common(top))


def launcher(lib: ctypes.CDLL):
    """A function (ops, out) → cudaError_t launching the library's float32
    form on the current kernel's keyword operands."""
    import torch

    fn = lib.gin_ell_launch
    # Null weight tiles in f32: two pointers (w1t, w2t), one packed operand
    # and a ring depth (the current interface), or none.
    ring = hasattr(lib, "gin_ell_mlp_dims")
    tiles = 1 if ring else 2 if hasattr(lib, "gin_ell_tiles") else 0
    fn.argtypes = [_I] + [_P] * (12 + tiles) + [_I] * (11 if ring else 10) + [_I, _P]
    fn.restype = _I

    def run(ops: dict, out) -> int:
        h0 = ops["h0"]
        n, d = h0.shape
        w, L = ops["window"], ops["num_layers"]
        nw = -(-n // w)
        ptrs = [ops[k].data_ptr() for k in ("ell_meta", "h0", "pool_gl", "ee_tables", "w1_all",
                                             "b1_all", "w2_all", "b2_all", "eps_all", "pred_w")]
        ptrs += [None if ops["vn_col"] is None else ops["vn_col"].data_ptr()]
        ptrs += [None] * tiles
        return fn(0, *ptrs, out.data_ptr(), nw, n, w, ops["ell_meta"].shape[0] // nw, d,
                  ops["w1_all"].shape[0] // L, L, ops["ee_tables"].shape[0] // L, ops["gmax"],
                  ops["pred_w"].shape[1], *([0] if ring else []), h0.device.index,
                  torch.cuda.current_stream(h0.device).cuda_stream)

    return run


def stream_operands(profile: str, graphs: int, device) -> list:
    """The current kernel's keyword operands for every bucket of GIN's ELL
    stream of ``profile`` at the window ``choose_geometry`` gives, f32."""
    from flowgnn_tpu_torch.core.graphs import auto_edge_capacity, pack_dataset
    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
    from flowgnn_tpu_torch.models import base, gin, registry
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

    spec = registry.get("gin")
    gs = registry.apply_transforms(spec, synthetic_dataset(profile, seed=0, num_graphs=graphs))
    window, block = base.choose_geometry("gin", max(g.num_nodes for g in gs))
    buckets = list(pack_dataset(gs, node_capacity=NODE_CAP,
                                edge_capacity=auto_edge_capacity(gs, NODE_CAP),
                                graph_capacity=GRAPH_CAP, align_window=window))
    batches = base.as_batches_uniform(buckets, blocked="local_ell", window=window, block=block)
    params = params_from_numpy(synthetic_gin_params(0), FLOAT32, device)
    return [gin.ell_kernel_operands(params, base.to_device(b, device), FLOAT32) for b in batches]


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

    from flowgnn_tpu_torch.ops import local_layer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH",
                    help="a revision's csrc/gin_local_model.cu (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gin_ell_sources: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    from flowgnn_tpu_torch.ops import build as b

    dev = torch.device("cuda", 0)
    print(f"# current: f32 kernel {f32_opcodes(b.build_libraries(['gin_local_model'])[0])}")
    runs = {}
    for spec in args.source:
        label, path = spec.split("=", 1)
        so = build(label, Path(path))
        print(f"# {label}: f32 kernel {f32_opcodes(so)}")
        runs[label] = launcher(ctypes.CDLL(str(so)))
    for profile, graphs in CELLS:
        calls = stream_operands(profile, graphs, dev)
        outs = [torch.empty((-(-o["h0"].shape[0] // o["window"]) * o["gmax"],
                             o["pred_w"].shape[1]), dtype=torch.float32, device=dev) for o in calls]
        current = lambda: [local_layer.gin_local_model(**o) for o in calls]
        want = current()
        fns = {"current": current}
        for label, run in runs.items():
            fns[label] = (lambda run: lambda: [run(o, out) for o, out in zip(calls, outs)])(run)
            rcs = fns[label]()
            torch.cuda.synchronize()
            if any(rcs):
                raise RuntimeError(f"{label}: launch failed ({rcs})")
            for got, ref in zip(outs, want):
                scale = max(1.0, ref.abs().max().item())
                torch.testing.assert_close(got / scale, ref / scale, rtol=1e-4, atol=1e-4)
        order = ["current", *runs, *reversed(list(runs)), "current"]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cuda_ms(fns[k], args.reps))
        print(f"# gin {profile} ELL f32, {len(calls)} launches per stream, ms per stream in turns "
              f"({' '.join(order)}): " + "; ".join(
                  f"{k} {' / '.join(f'{t:.4f}' for t in ts)}" for k, ts in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
