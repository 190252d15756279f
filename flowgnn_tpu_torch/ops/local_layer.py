"""Graph-local whole-model kernels.

``gin_local_model_slots`` is the counterpart of the TPU kernel
``flowgnn_tpu/ops/pallas/local_layer.py:gin_local_model_slots``: the whole
GIN / GIN-VN model (L layers of slot gather, bond embedding, prefix
accumulation and update MLP, then the pool finalize) over the degree-sorted
dest-major slot layout, in one launch per bucket. On a CUDA tensor it
launches the hand-written kernel ``csrc/gin_local_model_slots.cu``; on a CPU
tensor it runs ``gin_local_model_slots_ref``, the same function in plain
torch, which the CPU tests hold against the JAX kernel.

The TPU kernel's ``wps`` (windows per grid step), its ``_pad_slot_operands``
and its ``_ablate`` stage stubs are not carried over: they batch TPU grid
steps to amortize MXU weight loads, or attribute TPU time, and the Hopper
kernel runs one block per window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import load_library

LIBRARY = "gin_local_model_slots"


def _slot_prefix_geom(prefix_caps, window: int, slots: int):
    """(caps, offsets, total lanes) of the degree-sorted prefix layout."""
    if prefix_caps is not None:
        caps = tuple(int(c) for c in prefix_caps)
    else:
        caps = tuple(window for _ in range(slots))
    offs = tuple(int(sum(caps[:k])) for k in range(len(caps)))
    return caps, offs, int(sum(caps))


def _center(window: int) -> int:
    """The offset slot_meta subtracts from in-window source indices."""
    return window // 2 if window <= 512 else 0


def gin_local_model_slots_ref(
    slot_meta: torch.Tensor,  # [NW·Σc, 4] int (src − W/2 ‖ attrs+offsets)
    h0: torch.Tensor,  # [n, D] embedded input features
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    ee_tables: torch.Tensor,  # [L·13, D] stacked bond-embedding tables
    w1_all: torch.Tensor,  # [L·H, D]
    b1_all: torch.Tensor,  # [L, H]
    w2_all: torch.Tensor,  # [L·D, H]
    b2_all: torch.Tensor,  # [L, D]
    eps_all: torch.Tensor,  # [L, 1] (1+ε per layer)
    pred_w: torch.Tensor,  # [D, T]
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
    vn_col: Optional[torch.Tensor] = None,  # [n] analytic-VN flag (GIN-VN)
) -> torch.Tensor:
    """Plain-torch ``gin_local_model_slots``: [NW·GMAX, T] pool sums.

    Products and sums run in f32 (f64 when h0 is f64) and the activations
    are rounded to h0's dtype where the kernel rounds them. The result is
    f32, or f64 for f64 inputs (the kernel has no f64 mode)."""
    cdt = h0.dtype
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, offs, sw = _slot_prefix_geom(prefix_caps, window, slots)
    vocab = ee_tables.shape[0] // num_layers
    hid = w1_all.shape[0] // num_layers
    relu = lambda x: torch.clamp_min(x, 0)

    h = torch.zeros(nw * window, d, dtype=cdt, device=dev)
    h[:n] = h0
    meta = slot_meta.reshape(nw, sw, 4).long()
    src = meta[..., 0] + _center(window)
    valid = ((src >= 0) & (src < window)).reshape(-1, 1).to(acc)
    win = torch.arange(nw, device=dev)[:, None]
    gather = (win * window + src.clamp(0, window - 1)).reshape(-1)
    attrs = meta[..., 1:].reshape(-1, 3)
    attr_rows = torch.where(attrs >= 0, attrs, vocab)  # row `vocab` is zero
    gl = pool_gl.long().reshape(nw, window).clamp(max=gmax)
    # Per-window graph slots plus one sink row (index gmax) for padding.
    pool_idx = (win * (gmax + 1) + gl).reshape(-1)
    vnc = None
    if vn_col is not None:
        vnc = torch.zeros(nw * window, 1, dtype=acc, device=dev)
        vnc[:n, 0] = vn_col.to(acc)

    for l in range(num_layers):
        tab = torch.cat([
            ee_tables[l * vocab : (l + 1) * vocab].to(acc),
            torch.zeros(1, d, dtype=acc, device=dev),
        ])
        hf = h.to(acc)
        ee = tab[attr_rows[:, 0]] + tab[attr_rows[:, 1]] + tab[attr_rows[:, 2]]
        msg = relu(hf[gather] + ee).to(cdt).to(acc) * valid
        msg = msg.reshape(nw, sw, d)
        agg = torch.zeros(nw, window, d, dtype=acc, device=dev)
        for k, c in enumerate(caps):
            agg[:, :c] += msg[:, offs[k] : offs[k] + c]
        agg = agg.reshape(nw * window, d)
        if vnc is not None:
            e0 = tab[0] + tab[5] + tab[11]  # the (0, 0, 0)-attr bond embedding
            r = relu(hf + e0).to(cdt).to(acc)
            rcat = torch.cat([r * (1 - vnc), r * vnc], dim=1)
            pooled = torch.zeros(nw * (gmax + 1), 2 * d, dtype=acc, device=dev)
            pooled.index_add_(0, pool_idx, rcat)
            pooled[gmax :: gmax + 1] = 0  # padding rows pool nothing
            back = pooled[pool_idx]
            agg = agg + back[:, d:] * (1 - vnc) + back[:, :d] * vnc
        act = (agg + eps_all[l, 0].to(acc) * hf).to(cdt)
        w1 = w1_all[l * hid : (l + 1) * hid].to(acc)
        w2 = w2_all[l * d : (l + 1) * d].to(acc)
        z = relu(act.to(acc) @ w1.T + b1_all[l].to(acc)).to(cdt)
        out = z.to(acc) @ w2.T + b2_all[l].to(acc)
        if l != num_layers - 1:
            out = relu(out)
        h = out.to(cdt)

    p = h.to(acc) @ pred_w.to(acc)
    t_out = pred_w.shape[1]
    pool = torch.zeros(nw * (gmax + 1), t_out, dtype=acc, device=dev)
    pool.index_add_(0, pool_idx, p)
    return pool.reshape(nw, gmax + 1, t_out)[:, :gmax].reshape(nw * gmax, t_out)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library(LIBRARY)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.gin_slots_max_d.restype = i32
    lib.gin_slots_max_slots.restype = i32
    lib.gin_slots_smem_optin.argtypes = [i32]
    lib.gin_slots_smem_optin.restype = i64
    lib.gin_slots_smem_bytes.argtypes = [i32] * 5 + [int_p, i32]
    lib.gin_slots_smem_bytes.restype = i64
    lib.gin_slots_launch.argtypes = (
        [i32] + [ptr] * 12 + [i32] * 10 + [int_p, i32, i32, ptr]
    )
    lib.gin_slots_launch.restype = i32
    lib.gin_slots_error_string.argtypes = [i32]
    lib.gin_slots_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(slot_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
            eps_all, pred_w, window, slots, num_layers, gmax, prefix_caps,
            vn_col) -> torch.Tensor:
    dt = h0.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h0: dtype {dt}; the kernel takes float32 or bfloat16")
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, sw = _slot_prefix_geom(prefix_caps, window, slots)
    L = num_layers
    vocab = ee_tables.shape[0] // L
    hid = w1_all.shape[0] // L
    t_out = pred_w.shape[1]
    _check("slot_meta", slot_meta, torch.int32, (nw * sw, 4), dev)
    _check("h0", h0, dt, (n, d), dev)
    _check("pool_gl", pool_gl, torch.int32, (nw * window,), dev)
    _check("ee_tables", ee_tables, dt, (L * vocab, d), dev)
    _check("w1_all", w1_all, dt, (L * hid, d), dev)
    _check("b1_all", b1_all, dt, (L, hid), dev)
    _check("w2_all", w2_all, dt, (L * d, hid), dev)
    _check("b2_all", b2_all, dt, (L, d), dev)
    _check("eps_all", eps_all, torch.float32, (L, 1), dev)
    _check("pred_w", pred_w, dt, (d, t_out), dev)
    if vn_col is not None:
        _check("vn_col", vn_col, dt, (n,), dev)
        if vocab != 13:
            raise ValueError("the analytic VN stage needs the 13-row bond vocabulary")
    if any(c > window for c in caps):
        raise ValueError(f"prefix caps {caps} exceed the window {window}")

    lib = _library()
    if d > lib.gin_slots_max_d():
        raise ValueError(f"D={d} exceeds the kernel's tile ({lib.gin_slots_max_d()})")
    if not 1 <= slots <= lib.gin_slots_max_slots():
        raise ValueError(f"slots={slots} outside 1..{lib.gin_slots_max_slots()}")
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    smem = lib.gin_slots_smem_bytes(window, d, vocab, gmax, t_out, caps_arr, slots)
    limit = lib.gin_slots_smem_optin(dev.index)
    if limit < 0:
        raise RuntimeError(lib.gin_slots_error_string(int(-limit)).decode())
    if smem > limit:
        raise ValueError(
            f"window {window} × D {d} needs {smem} B of shared memory per "
            f"block; this card allows {limit} B"
        )

    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib.gin_slots_launch(
        0 if dt == torch.float32 else 1,
        slot_meta.data_ptr(), h0.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), w1_all.data_ptr(), b1_all.data_ptr(),
        w2_all.data_ptr(), b2_all.data_ptr(), eps_all.data_ptr(),
        pred_w.data_ptr(), None if vn_col is None else vn_col.data_ptr(),
        out.data_ptr(),
        nw, n, window, _center(window), d, hid, L, vocab, gmax, t_out,
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"gin_local_model_slots launch failed: "
            f"{lib.gin_slots_error_string(rc).decode()}"
        )
    gin_local_model_slots.launches += 1
    return out


def gin_local_model_slots(
    slot_meta: torch.Tensor,
    h0: torch.Tensor,
    pool_gl: torch.Tensor,
    ee_tables: torch.Tensor,
    w1_all: torch.Tensor,
    b1_all: torch.Tensor,
    w2_all: torch.Tensor,
    b2_all: torch.Tensor,
    eps_all: torch.Tensor,
    pred_w: torch.Tensor,
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
    vn_col: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GIN whole-model slot megakernel: [NW·GMAX, T] f32 per-window pool
    sums (``base.pool_finish`` divides by node counts and adds the bias).

    Operands as in ``gin_local_model_slots_ref``. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel, which takes float32
    or bfloat16 activations and weights with int32 ``slot_meta`` /
    ``pool_gl`` and float32 ``eps_all``, or raises. Each launch adds one to
    ``gin_local_model_slots.launches``."""
    args = (slot_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
            eps_all, pred_w, window, slots, num_layers, gmax, prefix_caps, vn_col)
    if h0.device.type == "cpu":
        return gin_local_model_slots_ref(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return _launch(*args)


gin_local_model_slots.launches = 0
