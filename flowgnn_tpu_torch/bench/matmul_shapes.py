"""Chained matmuls at the kernels' matrix shapes: what the card's tensor
cores reach there.

The counterpart of ``flowgnn_tpu.bench.matmul_shapes``: per shape, ``grid``
tiles of ``M`` rows of A run ``layers`` dependent products with one shared B
(no gather, no masks, no kernel glue), bf16 and int8, at exactly the shapes
of the JAX package's kernels plus a fat anchor. ``chained_matmul`` is the
hand-written ``wgmma`` kernel (``csrc/chained_matmul.cu``), which takes B
packed K-major into its shared-memory layout (``ops.tiles``);
``chained_matmul_ref`` its plain version.

Run on the card: ``python -m flowgnn_tpu_torch.bench.matmul_shapes [--reps
100] [--trials 3]``. Each row: the shape, µs per launch (the best of
``--trials`` runs of ``--reps`` back-to-back launches, CUDA events, after a
warm-up), TF/s and the share of the H100's nominal bf16 peak. The ``#
launch floor`` line is one empty kernel launch timed the same way; it is
printed, not subtracted. ``--device cpu`` runs the plain version with a host
clock instead, for a check of the control flow only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import sys
import time

import torch

from ..ops.build import load_library
from ..ops.tiles import kmajor_tiles
from .roofline import H100

# (label, M, K, N, layers per step, grid, dtype): the JAX tool's shapes.
SHAPES = [
    ("gin gather/scatter [896,384]@[384,128]", 896, 384, 128, 10, 85, "bf16"),
    ("gat slot gather [1536,256]@[256,128]", 1536, 256, 128, 5, 128, "bf16"),
    ("gat slot gather int8", 1536, 256, 128, 5, 128, "int8"),
    ("pna slot gather [512,512]@[512,128]", 512, 512, 128, 5, 64, "bf16"),
    ("glue [256,64]@[64,136]", 256, 64, 136, 5, 128, "bf16"),
    ("fat anchor [1024,1024]@[1024,256]", 1024, 1024, 256, 5, 48, "bf16"),
    ("fat anchor int8", 1024, 1024, 256, 5, 48, "int8"),
    ("gin-vn gather/scatter [640,256]@[256,128]", 640, 256, 128, 10, 128, "bf16"),
    ("slot-stage W256 [256,256]@[256,128]", 256, 256, 128, 10, 128, "bf16"),
    ("slot-stage W384 [384,384]@[384,128]", 384, 384, 128, 10, 96, "bf16"),
    ("gat pairs two-hot [896,512]@[512,128]", 896, 512, 128, 5, 64, "bf16"),
    ("gat pairs glue [256,128]@[128,256]", 256, 128, 256, 5, 128, "bf16"),
]
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}
LIBRARIES = ("chained_matmul",)


def chained_matmul_ref(a: torch.Tensor, b: torch.Tensor, layers: int, grid: int) -> torch.Tensor:
    """Plain torch: [grid·M, N] f32, per row of ``a`` ([grid·M, K], bf16 or
    int8) ``layers`` times prod = a·b (f32; int8 exact, in f64), acc +=
    prod, a = cast(relu(a) + prod[:, 0]·1e-9) with the add and the multiply
    in f32 (bf16 rounds to nearest even, int8 truncates toward zero), as the
    JAX kernel body (``matmul_shapes.py:58-74``). Rows are independent, so
    ``grid`` only sets the tiling the shape is named by."""
    int8 = a.dtype == torch.int8
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=a.device)
    x = a
    for _ in range(layers):
        # |prod| < 2^24 for |a|, |b| <= 127 and K <= 1024: exact in f32.
        prod = (x.double() @ b.double()).float() if int8 else x.float() @ b.float()
        acc += prod
        x = (torch.clamp_min(x.float(), 0) + prod[:, :1] * eps).to(a.dtype)
    return acc


@functools.cache
def _library() -> dict:
    lib = load_library("chained_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, args, res in (
        ("max_n", [], i32), ("smem_optin", [i32], ctypes.c_longlong),
        ("padded_n", [i32] * 3 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)], i32),
        ("launch", [i32] + [ptr] * 3 + [i32] * 6 + [ptr], i32),
        ("empty_launch", [i32, ptr], i32), ("error_string", [i32], ctypes.c_char_p),
    ):
        f = getattr(lib, f"cmm_{name}")
        f.argtypes, f.restype = args, res
        fns[name] = f
    return fns


def _raise_on(lib: dict, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib['error_string'](rc).decode()}")


def _launch(a: torch.Tensor, b: torch.Tensor, layers: int, grid: int) -> torch.Tensor:
    if a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"a: dtype {a.dtype}; the kernel takes bfloat16 or int8")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"b: {b.dtype} on {b.device}, a: {a.dtype} on {a.device}")
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous and 16-byte aligned")
    rows, k = a.shape
    n = b.shape[1]
    lib = _library()
    if rows % grid or layers < 1:
        raise ValueError(f"{rows} rows are not {grid} tiles, or layers={layers} < 1")
    if k % 32 or n % 8 or not 8 <= n <= lib["max_n"]():
        raise ValueError(f"K={k} must be a multiple of 32 and N={n} one of 8 up to "
                         f"{lib['max_n']()}")
    code = 1 if a.dtype == torch.int8 else 0
    dev = a.device
    limit = lib["smem_optin"](dev.index)
    if limit < 0:
        raise RuntimeError(lib["error_string"](int(-limit)).decode())
    smem = ctypes.c_longlong(0)
    np_ = lib["padded_n"](code, k, n, limit, ctypes.byref(smem))
    if np_ == 0:
        raise ValueError(f"K={k}, N={n}: no layout of the kernel fits this card's {limit} B "
                         "of shared memory per block")
    # B as the kernel's wgmma operand: Bᵀ K-major, N padded to its tile.
    bt = kmajor_tiles(b.t(), np_, k)
    out = torch.empty(rows, n, dtype=torch.float32, device=dev)
    rc = lib["launch"](code, a.data_ptr(), bt.data_ptr(), out.data_ptr(), rows, k, n, np_,
                       layers, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "chained_matmul launch")
    chained_matmul.launches += 1
    return out


def chained_matmul(a: torch.Tensor, b: torch.Tensor, layers: int, grid: int) -> torch.Tensor:
    """The chained product of ``chained_matmul_ref``. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (bf16 or int8, K a
    multiple of 32, N a multiple of 8 up to 256) or raises. Each launch adds
    one to ``chained_matmul.launches``."""
    if a.device.type == "cpu":
        return chained_matmul_ref(a, b, layers, grid)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _launch(a, b, layers, grid)


chained_matmul.launches = 0


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel on the current stream."""
    lib = _library()
    _raise_on(lib, lib["empty_launch"](device.index, torch.cuda.current_stream(device).cuda_stream),
              "empty launch")


def best_seconds(fn, reps: int, trials: int, device: torch.device) -> float:
    """The best over ``trials`` of the seconds per call of ``reps``
    back-to-back calls of ``fn``, after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(trials):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / reps)
    return best


def operands(m: int, k: int, n: int, grid: int, dtype: str, device) -> tuple:
    """The all-ones A [grid·M, K] and B [K, N] the JAX tool times."""
    dt = DTYPES[dtype]
    return (torch.ones(grid * m, k, dtype=dt, device=device),
            torch.ones(k, n, dtype=dt, device=device))


def measure(m, k, n, layers, grid, dtype, reps, trials=3, device="cuda") -> float:
    """Best seconds per launch of the chained product on all-ones operands
    (``best_seconds``), as the JAX ``measure`` returns them."""
    device = torch.device(device)
    a, b = operands(m, k, n, grid, dtype, device)
    return best_seconds(lambda: chained_matmul(a, b, layers, grid), reps, trials, device)


def tool_device(name: str, file=None) -> torch.device:
    """A bench tool's ``--device``: the CPU only when asked for; a card must
    be there, and its name and power limit are printed (to ``file``, stdout
    by default), as ``nvidia-smi`` gives them, beside the times."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        sys.exit(f"no CUDA device for --device {name} (--device cpu runs the plain versions)")
    device = torch.device("cuda", device.index or 0)
    print("# " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index)], capture_output=True, text=True, check=True).stdout.strip(),
        file=file or sys.stdout)
    return device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    if device.type == "cuda":
        floor = best_seconds(lambda: empty_launch(device), args.reps, args.trials, device)
    else:
        floor = best_seconds(lambda: None, args.reps, args.trials, device)
    print(f"# launch floor {floor * 1e6:.2f} us per launch (printed, not subtracted)")
    for label, m, k, n, layers, grid, dtype in SHAPES:
        t = measure(m, k, n, layers, grid, dtype, args.reps, args.trials, device)
        tf = 2.0 * m * k * n * layers * grid / t / 1e12
        eff = tf / (H100.peak_bf16_flops / 1e12)
        print(f"{label:45s} {t * 1e6:9.1f} us  {tf:7.1f} TF/s "
              f"{eff * 100:5.1f}% of nominal bf16 peak")


if __name__ == "__main__":
    main()
