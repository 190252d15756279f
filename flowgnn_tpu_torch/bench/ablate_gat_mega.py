"""GAT whole-model megakernel ablation: in-kernel stage knockouts.

The counterpart of ``flowgnn_tpu.bench.ablate_gat_mega``. The megakernel
runs a whole GAT model in one launch, so a stage's cost shows only by
running the kernel with that stage knocked out and timing each variant:

  noop      — ``h0 * 0 + 1``, one plain torch op timed the same way
  slots     — the port's row-5 kernel (``ops.local_layer.gat_local_model_slots``)
  dense     — the same kernel: the JAX package's slot and dense megakernels
              (rows 6, 7) compute row 5's function and are merged into it
  full      — the round-2 (v1) slot form: full S·W slot stack, per-layer
              skip, projection and score matmuls, scores rounded
  noexp     — score = raw·valid (leaky and exp removed)
  nogather  — lane i takes row i mod W instead of its source row
  noexpand  — head 0's score and denominator for every column
  repeat    — v1 ``full``'s function (a TPU lane-layout experiment)
  noglue    — no skip / projection / score matmuls between layers
  nopool    — the last layer's (msg + skip)[:GMAX, :T] per window, unpooled
  nodivide  — no softmax divide
  nocast    — msg not rounded to the compute dtype
  staticcat — every layer gathers layer 0's [h ‖ s_tgt]
  addcat    — layer 0's [h ‖ s_tgt] + l·1e-7 in the compute dtype
  v3[:x]    — the round-3 form (prefix-compacted stack, one fused glue
              matmul); x one of nogather bf16hu split stackexp noexp noexpand
              nodivide nocast noelu noglue nopool (bf16hu, split and
              stackexp compute v3 ``full``'s function)
  v4[:x]    — v3 with the gather one-hot as an operand; x: nogather
  v5[:x]    — v3 with each head's score expanded to H·D columns; x: split
              (v5 ``full``'s function), nogather
  r5[:x]    — row 5's own form (prefix caps, scores mapped from h each
              layer, the glue [proj ‖ skip]) with row 5's TPU stage stubs
              (``gat_local_model_pairs(_ablate=...)``); x one of, or a
              comma set of, nogather (as v1's), noscore (every valid lane's
              score 1, no score map), noglue (h = feat, skip kept) and noacc
              (row r takes the window's lane r alone, its denominator
              score + 1); ``bench.ablate_gat_pairs`` drives it

Every form runs row 5's kernel body (``csrc/gat_model.cuh``, the kernel
of ``ops.local_layer.gat_local_model_slots``) with that form's operands and
rounding points, through one wrapper, ``gat_mega_ablate``, whose knockouts
are runtime flags: a cluster of W/128 blocks a window for W = 128..1024,
the bf16 glue products on the tensor cores (``wgmma``; v4's one-hot gather
too), the weights packed once per weight set (``glue_tiles``). The plain
version ``gat_mega_ablate_ref`` copies the JAX variant factories'
arithmetic and rounding points. Subtract noop; (full − variant) is then
the stage's device time per pass in row 5's design.

Run on the card: ``python -m flowgnn_tpu_torch.bench.ablate_gat_mega [--reps
100] [--trials 3] [--graphs 1028] [--ell-window W] [--variants
full,noexp,...]``; ``--ell-window`` takes 128..1024 in whole blocks of 128
rows (default ``choose_geometry``'s, 128 on molhiv). Each row is timed on
the card by CUDA-graph replay (``bench.timing.graph_ms``: the launches'
device time, without the wrapper's host work), the best of ``--trials``
means of ``--reps`` replays. The JAX tool loads the reference GAT weights;
the port uses seeded synthetic weights at full width (4 heads × 16, L=5)
in bf16. ``--device cpu`` runs the plain versions with a host clock, for a
check of the control flow only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import torch

from ..ops.build import load_library
from ..ops.local_layer import (
    GAT_PITCH, _pack_once, _padded, _pool_sums, _two_blocks_budget, linear_geometry,
    linear_tiles, ring_stages,
)

LIBRARIES = ("gat_mega_ablate",)
# Each form's variants, in the JAX tool's order; the second tuple: variants
# that compute the form's ``full`` function (TPU layout experiments), which
# run the ``full`` path under their own name.
FORMS = {
    "v1": (("full", "noexp", "nogather", "noexpand", "repeat", "noglue", "nopool",
            "nodivide", "nocast", "staticcat", "addcat"), ("repeat",)),
    "v3": (("full", "nogather", "bf16hu", "split", "stackexp", "noexp", "noexpand",
            "nodivide", "nocast", "noelu", "noglue", "nopool"), ("bf16hu", "split", "stackexp")),
    "v4": (("full", "nogather"), ()),
    "v5": (("full", "split", "nogather"), ("split",)),
}
# Row 5's own form (code 0): its TPU stage stubs, any comma set of them
# (``bench.ablate_gat_pairs``); not one of the JAX tool's forms.
ROW5_VARIANTS = ("full", "nogather", "noscore", "noglue", "noacc")
FLAGS = {"noexp": 1, "nogather": 2, "noexpand": 4, "noglue": 8, "nopool": 16,
         "nodivide": 32, "nocast": 64, "staticcat": 128, "addcat": 256, "noelu": 512,
         "noscore": 1024, "noacc": 2048}
FORM_CODES = {"r5": 0, "v1": 1, "v3": 3, "v4": 4, "v5": 5}
# Each form's bf16 glue width N (``csrc/gat_model.cuh``: the forms' kGlueN),
# which the host packs the weights for; the launch checks it against the
# library's ``gma_glue_dims``.
GLUE_N = {"r5": 2 * GAT_PITCH, "v1": 2 * GAT_PITCH, "v3": 136, "v4": 136, "v5": 256}


def _flags(form: str, variant: str) -> int:
    """The knockout flags of ``variant`` (r5: a comma set of its stubs)."""
    names, same = (ROW5_VARIANTS, ()) if form == "r5" else FORMS[form]
    parts = variant.split(",") if form == "r5" else [variant]
    flags = 0
    for part in parts:
        if part not in names or (part == "full" and len(parts) > 1):
            raise ValueError(f"{form} has no variant {variant!r} (it has {', '.join(names)})")
        flags |= 0 if part == "full" or part in same else FLAGS[part]
    return flags


def _geometry(form: str, window: int, slots: int, prefix_caps):
    """(caps, offsets, lanes per window): v1 gathers all S·W lanes."""
    caps = (window,) * slots if form == "v1" or prefix_caps is None else tuple(
        int(c) for c in prefix_caps)
    offs = tuple(sum(caps[:k]) for k in range(len(caps)))
    return caps, offs, sum(caps)


def gat_mega_ablate_ref(form: str, variant: str, stack, h0, x0, s0, w, pool_gl, pred_hd,
                        window: int, slots: int, num_heads: int, num_layers: int, gmax: int,
                        prefix_caps=None, proj_w=None, a_next=None) -> torch.Tensor:
    """Plain torch, [NW·GMAX, T] f32: the JAX variant factory of ``form`` with
    ``variant`` knocked out. Operands: ``stack`` the v1 ``slot_stack``
    [NW·S·W], the v3 / v5 ``slot_pstack`` [NW·Σc] or the v4 one-hot tiles
    [NW·Σc, W]; ``h0`` [n, HD]; ``x0`` v1's ``prev0``, else ``skip0`` [n,
    HD]; ``s0`` [n, 2H] [s_src ‖ s_tgt] (v5: ``s0x`` [n, 2HD]); ``w`` v1's
    ``skip_w`` [L·HD, HD], v3 / v4's ``glue_w``, v5's ``glue_wx``; v1 also
    ``proj_w`` and ``a_next``; r5 (row 5's form) ``stack`` the
    ``slot_pstack``, ``x0`` skip0, ``w`` and ``proj_w`` row 5's skip_w and
    proj_w (layers 1..L−1), ``a_next`` its a_all (every layer), no ``s0``.
    Products and sums in f32, rounding to h0's dtype where the JAX kernels
    cast."""
    flags = _flags(form, variant)
    if form == "r5":
        return _row5_ref(flags, stack, h0, x0, w, proj_w, a_next, pool_gl, pred_hd, window,
                         slots, num_heads, num_layers, gmax, prefix_caps)
    on = lambda name: bool(flags & FLAGS[name])
    cdt = h0.dtype
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    rnd = lambda x: x.to(cdt).to(acc)
    dev = h0.device
    n, hd = h0.shape
    nh = num_heads
    nw = -(-n // window)
    rows = nw * window
    caps, offs, sw = _geometry(form, window, slots, prefix_caps)
    sw_ = hd if form == "v5" else nh  # score columns per row
    pad = lambda x: _padded(x, rows).to(acc)
    s0 = pad(s0)
    px = torch.cat([pad(h0), s0[:, sw_:]], dim=1)  # the gathered payload [h ‖ s_tgt]
    ss = s0[:, :sw_]
    skip = prev = pad(x0)
    win = torch.arange(nw, device=dev)[:, None]
    mod = torch.arange(sw, device=dev) % window
    if form == "v4":
        onehot = stack.reshape(nw, sw, window).to(acc)
        valid = onehot.sum(-1, keepdim=True)
    else:
        u = stack.reshape(nw, sw).long()
        valid = (u < window).to(acc)[..., None]
        inwin = ((u >= 0) & (u < window))[..., None]
    px0 = px
    for l in range(num_layers):
        last = l == num_layers - 1
        payload = px
        if on("staticcat"):
            payload = px0
        elif on("addcat"):
            payload = rnd(px0 + torch.tensor(l * 1e-7, dtype=cdt).to(acc))
        p3 = payload.reshape(nw, window, -1)
        if on("nogather"):
            hu = p3[:, mod]
        elif form == "v4":
            hu = onehot @ p3
        else:
            hu = torch.where(inwin, p3[win, u.clamp(0, window - 1)], 0.0)
        ss3 = ss.reshape(nw, window, -1)
        num = torch.zeros(nw, window, hd, dtype=acc, device=dev)
        den = torch.zeros_like(num)
        for k, c in enumerate(caps):
            lane = slice(offs[k], offs[k] + c)
            raw = ss3[:, :c] + hu[:, lane, hd : hd + sw_]
            score = raw if on("noexp") else torch.exp(torch.where(raw < 0, raw * 0.2, raw))
            score = score * valid[:, lane]
            if form == "v5":
                scorex = score
            elif on("noexpand"):
                scorex = score[..., :1].expand(-1, -1, hd)
            else:
                scorex = score.repeat_interleave(hd // nh, dim=-1)
            num[:, :c] += scorex * hu[:, lane, :hd]
            den[:, :c] += scorex
        msg = num if on("nodivide") else num / torch.where(den == 0, 1.0, den)
        msg = msg.reshape(rows, hd)
        if not on("nocast"):
            msg = rnd(msg)
        if form == "v1" and on("noglue"):
            if last:
                final = msg
                break
            px = torch.cat([rnd(msg), px[:, hd:]], dim=1)
            prev = rnd(msg)
            continue
        if form == "v1":
            skip = prev @ w[l * hd : (l + 1) * hd].to(acc)
        if last:
            final = msg + skip
            break
        feat = msg + skip
        if not on("noelu"):
            feat = torch.where(feat <= 0, torch.exp(feat) - 1, feat)
        feat = rnd(feat)
        if form == "v1":
            prev = feat
            h = rnd(feat @ proj_w[l * hd : (l + 1) * hd].to(acc))
            scat = h @ a_next[l * hd : (l + 1) * hd].to(acc)
            ss, px = rnd(scat[:, :nh]), torch.cat([h, rnd(scat[:, nh:])], dim=1)
        elif on("noglue"):  # v3
            px = torch.cat([feat, torch.zeros(rows, nh, dtype=acc, device=dev)], dim=1)
            skip = feat
        else:
            g = feat @ w[l * hd : (l + 1) * hd].to(acc)
            pay = 2 * hd if form == "v5" else w.shape[1] - hd - nh
            px = rnd(g[:, : hd + sw_])
            skip = g[:, pay : pay + hd]
            ss = rnd(g[:, pay + hd : pay + hd + sw_])
    t_out = pred_hd.shape[1]
    if on("nopool") and not (form == "v1" and on("noglue")):
        return final.reshape(nw, window, hd)[:, :gmax, :t_out].reshape(nw * gmax, t_out).float()
    return _pool_sums(rnd(final) @ pred_hd.to(acc), pool_gl, nw, window, gmax).float()


def _row5_ref(flags: int, stack, h0, skip0, skip_w, proj_w, a_all, pool_gl, pred_hd,
              window: int, slots: int, num_heads: int, num_layers: int, gmax: int,
              prefix_caps) -> torch.Tensor:
    """Row 5's function (``ops.local_layer.gat_local_model_slots_ref``) with
    the ``flags`` of its stage stubs: nogather (lane i's source is row i
    mod W), noscore (score 1 on every valid lane, no score map), noacc (row
    r takes the window's lane r alone, its denominator score + 1) and
    noglue (h = feat, skip kept)."""
    on = lambda name: bool(flags & FLAGS[name])
    cdt = h0.dtype
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    rnd = lambda x: x.to(cdt).to(acc)
    dev = h0.device
    n, hd = h0.shape
    nh = num_heads
    nw = -(-n // window)
    rows = nw * window
    caps, offs, sw = _geometry("r5", window, slots, prefix_caps)
    per_head = lambda x: x.repeat_interleave(hd // nh, dim=-1)
    u = stack.long().reshape(nw, sw)
    lane = torch.arange(sw, device=dev)
    src = lane.expand(nw, sw) % window if on("nogather") else u.clamp(0, window - 1)
    valid = (u < window).to(acc)[..., None]
    win = torch.arange(nw, device=dev)[:, None]
    if on("noacc"):  # row r: the window's lane r
        m = min(sw, window)
        dest = torch.arange(m, device=dev)
        src, valid, lanes = src[:, :m], valid[:, :m], [(slice(0, m), m)]
    else:
        dest = torch.cat([torch.arange(c, device=dev) for c in caps])
        lanes = [(slice(offs[k], offs[k] + c), c) for k, c in enumerate(caps)]
    h = _padded(h0, rows).to(acc)
    skip = _padded(skip0, rows).to(acc)
    for l in range(num_layers):
        h3 = h.reshape(nw, window, hd)
        hu = h3[win, src]
        if on("noscore"):
            score = valid.expand(-1, -1, nh)
        else:
            s = (h @ a_all[l * hd : (l + 1) * hd].to(acc)).reshape(nw, window, 2 * nh)
            raw = s[:, dest, :nh] + s[win, src, nh:]
            score = torch.where(valid > 0, torch.exp(torch.where(raw < 0, raw * 0.2, raw)), 0.0)
        num = torch.zeros(nw, window, hd, dtype=acc, device=dev)
        den = torch.zeros(nw, window, nh, dtype=acc, device=dev)
        for sl, c in lanes:
            num[:, :c] += per_head(score[:, sl]) * hu[:, sl]
            den[:, :c] += score[:, sl]
        if on("noacc"):
            den = den + 1
        msg = rnd((num / per_head(torch.where(den == 0, 1.0, den))).reshape(rows, hd))
        if l == num_layers - 1:
            break
        x = msg + skip
        feat = rnd(torch.where(x <= 0, torch.exp(x) - 1, x))
        if on("noglue"):
            h = feat
            continue
        h = rnd(feat @ proj_w[l * hd : (l + 1) * hd].to(acc))
        skip = feat @ skip_w[l * hd : (l + 1) * hd].to(acc)
    return _pool_sums(rnd(msg + skip) @ pred_hd.to(acc), pool_gl, nw, window, gmax).float()


# ---------------------------------------------------------------------------
# The kernel: build, bind, check, launch.
# ---------------------------------------------------------------------------


def _glue_matrix(form: str, w: torch.Tensor, proj_w, hd: int, num_heads: int) -> torch.Tensor:
    """Each layer's glue product B [H·D, N] of ``form`` (feat · B, the
    columns its kernel writes; ``csrc/gat_model.cuh``), [layers, H·D, N] in
    ``w``'s dtype, pads zero: r5 [proj_{l+1} ‖ skip_{l+1}] with skip at
    column 64 (row 5's ``gat_glue_tiles``); v1 [proj_l ‖ skip_{l+1}] with skip at column
    64, after layer 0's skip_w[0] (columns < H·D); v3 / v4 glue_w's used
    columns [h ‖ s_tgt ‖ skip ‖ s_src] (its zero pad dropped); v5 glue_wx.
    ``w``: v1's skip_w, v3 / v4's glue_w, v5's glue_wx; ``proj_w`` v1's."""
    n = GLUE_N[form]
    layers = w.shape[0] // hd
    b = w.new_zeros(layers, hd, n)
    w3 = w.view(layers, hd, -1)
    if form == "r5":
        b[..., :hd] = proj_w.view(layers, hd, hd)
        b[..., GAT_PITCH : GAT_PITCH + hd] = w3
    elif form == "v1":
        b[0, :, :hd] = w3[0]
        b[1:, :, :hd] = proj_w.view(layers - 1, hd, hd)
        b[1:, :, GAT_PITCH : GAT_PITCH + hd] = w3[1:]
    elif form == "v5":
        b[..., : 4 * hd] = w3
    else:
        cols = hd + num_heads
        pay = w.shape[1] - cols
        b[..., :cols] = w3[..., :cols]
        b[..., cols : 2 * cols] = w3[..., pay:]
    return b


def glue_tiles(form: str, w: torch.Tensor, proj_w, hd: int, num_heads: int) -> torch.Tensor:
    """``form``'s bf16 glue chunks as its kernel streams them, packed once per
    weight set (``ops.local_layer._pack_once``: again after an in-place
    update): [layers, C, 32·N], layer l's ``_glue_matrix`` as the wgmma B
    operand in chunks of 32 input channels (``linear_tiles``); v1's layer 0
    (its N = 64 skip product) in the first half of each chunk."""
    def pack():
        b = _glue_matrix(form, w, proj_w, hd, num_heads).transpose(1, 2)
        n = GLUE_N[form]
        if form != "v1":
            return linear_tiles(b, n)
        first = linear_tiles(b[:1, :GAT_PITCH], GAT_PITCH)
        first = torch.cat([first, torch.zeros_like(first)], dim=2)
        return torch.cat([first, linear_tiles(b[1:], n)])

    sources = (w, proj_w) if form in ("v1", "r5") else (w,)
    return _pack_once(("gat_mega_ablate", form, hd, num_heads), sources, pack)


@functools.cache
def _library() -> dict:
    lib = load_library("gat_mega_ablate")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    int_p = ctypes.POINTER(ctypes.c_int)
    fns = {}
    for name, args, res in (
        ("max_d", [], i32), ("max_heads", [], i32), ("max_slots", [], i32),
        ("rows_per_block", [], i32), ("max_cluster", [], i32), ("max_window", [], i32),
        ("blocks_per_sm", [i32], i32),
        ("glue_dims", [i32, i32, int_p], None), ("smem_optin", [i32], i64),
        ("smem_per_sm", [i32], i64), ("smem_bytes", [i32] * 9, i64),
        ("occupancy", [i32] * 10 + [int_p], i32),
        ("launch", [i32] * 2 + [ptr] * 11 + [i32] * 8 + [int_p] + [i32] * 5 + [ptr], i32),
        ("error_string", [i32], ctypes.c_char_p),
    ):
        f = getattr(lib, f"gma_{name}")
        f.argtypes, f.restype = args, res
        fns[name] = f
    return fns


def _error(lib, code: int) -> str:
    return lib["error_string"](int(code)).decode()


@functools.cache
def _plan(form: str, code: int, window: int, hd: int, nh: int, gmax: int, t_out: int, flags: int,
          device: int) -> tuple[int, int]:
    """The launch plan of ``form`` at this geometry, worked out once: (the
    bf16 weight ring's depth, the block's shared memory). The ring is the
    deepest that keeps the blocks an SM the form's bf16 kernel is built
    for (``gma_blocks_per_sm``: two for v1 and v3, as row 5); raises
    where the card's shared memory or the kernel's geometry refuses it."""
    lib = _library()
    fc = FORM_CODES[form]
    limit = lib["smem_optin"](device)
    if limit < 0:
        raise RuntimeError(_error(lib, -limit))
    smem_of = lambda stages: lib["smem_bytes"](fc, code, window, hd, nh, gmax, t_out, stages, flags)
    stages = 0
    if code == 1:
        kp, chunks, elems = linear_geometry(hd, GLUE_N[form])
        dims = (ctypes.c_int * 3)()
        lib["glue_dims"](fc, hd, dims)
        if tuple(dims) != (kp, GLUE_N[form], elems * 2):
            raise RuntimeError(f"the kernel's glue geometry {tuple(dims)} is not the host's "
                               f"{(kp, GLUE_N[form], elems * 2)}")
        two = lib["blocks_per_sm"](fc) == 2
        budget = _two_blocks_budget(lib, torch.device("cuda", device)) if two else limit
        stages = ring_stages(smem_of, chunks, budget)
    smem = smem_of(stages)
    if smem > limit:
        raise ValueError(f"{form} at window {window} × H·D {hd} needs {smem} B of shared memory "
                         f"per block; this card allows {limit} B")
    return stages, smem


def occupancy(form: str, dtype: torch.dtype, window: int, hd: int, num_heads: int, gmax: int,
              t_out: int, device, flags: int = 0) -> dict:
    """What the occupancy calculator says of ``form``'s kernel in ``dtype``
    at this geometry on ``device`` (the launch's own plan): the block's
    shared memory, the weight ring, the blocks one SM holds and the clusters
    of W/128 blocks that run at once."""
    code = 0 if dtype == torch.float32 else 1
    dev = torch.device(device)
    stages, smem = _plan(form, code, window, hd, num_heads, gmax, t_out, flags, dev.index)
    lib = _library()
    out = (ctypes.c_int * 2)()
    rc = lib["occupancy"](FORM_CODES[form], code, window, hd, num_heads, gmax, t_out, stages,
                          flags, dev.index, out)
    if rc != 0:
        raise RuntimeError(f"gat_mega_ablate occupancy: {_error(lib, rc)}")
    return dict(smem=smem, stages=stages, blocks_per_sm=out[0], clusters=out[1])


def _check(name: str, t, dtype, shape, device) -> None:
    if t is None:
        raise ValueError(f"{name}: missing")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(form, variant, stack, h0, x0, s0, w, pool_gl, pred_hd, window, slots, num_heads,
            num_layers, gmax, prefix_caps=None, proj_w=None, a_next=None) -> torch.Tensor:
    flags = _flags(form, variant)
    dt = h0.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h0: dtype {dt}; the kernel takes float32 or bfloat16")
    dev = h0.device
    n, hd = h0.shape
    nh, L = num_heads, num_layers
    t_out = pred_hd.shape[1]
    lib = _library()
    rows, most = lib["rows_per_block"](), lib["max_cluster"]()
    if window % rows or not 1 <= window // rows <= most:
        raise ValueError(f"window {window} is not 1..{most} whole blocks of {rows} rows")
    if hd % nh or hd > lib["max_d"]() or nh > lib["max_heads"]():
        raise ValueError(f"H·D={hd} over {nh} heads: the kernel takes H·D up to "
                         f"{lib['max_d']()} in up to {lib['max_heads']()} whole heads")
    if form in ("v3", "v4") and 2 * (hd + nh) > GLUE_N[form]:
        raise ValueError(f"{form}'s glue [h ‖ s_tgt ‖ skip ‖ s_src] at H·D={hd}, {nh} heads "
                         f"exceeds its {GLUE_N[form]} columns")
    if not 1 <= slots <= lib["max_slots"]():
        raise ValueError(f"slots={slots} outside 1..{lib['max_slots']()}")
    caps, _, sw = _geometry(form, window, slots, prefix_caps)
    if len(caps) != slots or any(not 0 <= c <= window for c in caps):
        raise ValueError(f"prefix caps {caps} do not fit {slots} slots of a {window}-row window")
    if flags & FLAGS["nopool"] and (gmax > window or t_out > hd):
        raise ValueError(f"nopool writes rows [:{gmax}] and columns [:{t_out}] of a window")
    nw = -(-n // window)
    if form == "v4":
        _check("onehot_tiles", stack, dt, (nw * sw, window), dev)
    else:
        _check("stack", stack, torch.int32, (nw * sw,), dev)
    _check("h0", h0, dt, (n, hd), dev)
    _check("x0", x0, dt, (n, hd), dev)
    if form == "r5":  # row 5 maps layer 0's scores itself
        if s0 is not None:
            raise ValueError("s0: r5 maps its scores from h0; pass None")
    else:
        _check("s0", s0, dt, (n, 2 * hd if form == "v5" else 2 * nh), dev)
    if form == "r5":
        ldw = hd
        _check("skip_w", w, dt, ((L - 1) * hd, hd), dev)
        _check("proj_w", proj_w, dt, ((L - 1) * hd, hd), dev)
        _check("a_all", a_next, dt, (L * hd, 2 * nh), dev)
    elif form == "v1":
        ldw = hd
        _check("skip_w", w, dt, (L * hd, hd), dev)
        _check("proj_w", proj_w, dt, ((L - 1) * hd, hd), dev)
        _check("a_next", a_next, dt, ((L - 1) * hd, 2 * nh), dev)
    else:
        ldw = 4 * hd if form == "v5" else max(128, hd + nh) + hd + nh
        _check("glue_w", w, dt, ((L - 1) * hd, ldw), dev)
    _check("pool_gl", pool_gl, torch.int32, (nw * window,), dev)
    _check("pred_hd", pred_hd, dt, (hd, t_out), dev)
    code = 0 if dt == torch.float32 else 1
    stages, _ = _plan(form, code, window, hd, nh, gmax, t_out, flags, dev.index)
    tiles = glue_tiles(form, w, proj_w, hd, nh) if code == 1 else None
    out = torch.empty(nw * gmax, t_out, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib["launch"](
        FORM_CODES[form], code, stack.data_ptr(), h0.data_ptr(), x0.data_ptr(), ptr(s0),
        w.data_ptr(), ptr(proj_w), ptr(a_next), pool_gl.data_ptr(), pred_hd.data_ptr(),
        ptr(tiles), out.data_ptr(), nw, n, window, hd, nh, L, gmax, t_out,
        (ctypes.c_int * len(caps))(*caps), slots, ldw, stages, flags, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gat_mega_ablate launch failed: {_error(lib, rc)}")
    gat_mega_ablate.launches += 1
    return out


def gat_mega_ablate(form: str, variant: str, stack, h0, x0, s0, w, pool_gl, pred_hd,
                    window: int, slots: int, num_heads: int, num_layers: int, gmax: int,
                    prefix_caps=None, proj_w=None, a_next=None) -> torch.Tensor:
    """The ablated megakernel of ``gat_mega_ablate_ref`` (operands there). A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16 activations and weights, int32 stacks) or raises.
    Each launch adds one to ``gat_mega_ablate.launches``."""
    args = (form, variant, stack, h0, x0, s0, w, pool_gl, pred_hd, window, slots, num_heads,
            num_layers, gmax, prefix_caps, proj_w, a_next)
    if h0.device.type == "cpu":
        return gat_mega_ablate_ref(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return _launch(*args)


gat_mega_ablate.launches = 0


# ---------------------------------------------------------------------------
# The JAX tool's variant factories: each returns a function of its form's operands.
# ---------------------------------------------------------------------------


def _variant_model(variant: str, window: int, slots: int, num_heads: int, num_layers: int,
                   gmax: int):
    """The round-2 (v1) slot form with ``variant`` knocked out."""
    geom = dict(window=window, slots=slots, num_heads=num_heads, num_layers=num_layers, gmax=gmax)
    _flags("v1", variant)

    def model(slot_stack, h0, prev0, s0, skip_w, proj_w, a_next, pool_gl, pred_hd):
        return gat_mega_ablate("v1", variant, slot_stack, h0, prev0, s0, skip_w, pool_gl,
                               pred_hd, proj_w=proj_w, a_next=a_next, **geom)

    return model


def _form_model(form: str, variant: str, window, slots, num_heads, num_layers, gmax,
                prefix_caps):
    geom = dict(window=window, slots=slots, num_heads=num_heads, num_layers=num_layers,
                gmax=gmax, prefix_caps=prefix_caps)
    _flags(form, variant)

    def model(stack, h0, skip0, s0, glue_w, pool_gl, pred_hd):
        return gat_mega_ablate(form, variant, stack, h0, skip0, s0, glue_w, pool_gl, pred_hd,
                               **geom)

    return model


def _variant_model_v3(variant: str, window: int, slots: int, num_heads: int, num_layers: int,
                      gmax: int, prefix_caps):
    """The round-3 form: ``model(pstack, h0, skip0, s0, glue_w, pool_gl,
    pred_hd)``."""
    return _form_model("v3", variant, window, slots, num_heads, num_layers, gmax, prefix_caps)


def _variant_model_v4(variant: str, window: int, slots: int, num_heads: int, num_layers: int,
                      gmax: int, prefix_caps):
    """v3 with the gather one-hot as an operand: ``model(onehot_tiles, h0,
    skip0, s0, glue_w, pool_gl, pred_hd)``; valid is the tile's row sum."""
    return _form_model("v4", variant, window, slots, num_heads, num_layers, gmax, prefix_caps)


def _variant_model_v5(variant: str, window: int, slots: int, num_heads: int, num_layers: int,
                      gmax: int, prefix_caps):
    """v3 with expanded scores: ``model(pstack, h0, skip0, s0x, glue_wx,
    pool_gl, pred_hd)`` (``expand_score_operands``)."""
    return _form_model("v5", variant, window, slots, num_heads, num_layers, gmax, prefix_caps)


def expand_score_operands(glue_w: torch.Tensor, s0: torch.Tensor, hd: int, num_heads: int):
    """v5's operands: each per-head score column repeated D times. glue_w's
    columns [h ‖ s_tgt ‖ pad ‖ skip ‖ s_src] → glue_wx [h ‖ s_tgt_exp ‖ skip
    ‖ s_src_exp]; s0 [s_src ‖ s_tgt] → s0x [s_src_exp ‖ s_tgt_exp]."""
    nh = num_heads
    pay = max(128, hd + nh)
    rep = lambda cols: cols.repeat_interleave(hd // nh, dim=1)
    glue_wx = torch.cat([glue_w[:, :hd], rep(glue_w[:, hd : hd + nh]),
                         glue_w[:, pay : pay + hd], rep(glue_w[:, pay + hd : pay + hd + nh])], 1)
    return glue_wx.contiguous(), torch.cat([rep(s0[:, :nh]), rep(s0[:, nh:])], 1).contiguous()


def onehot_tiles(stack: torch.Tensor, window: int, lanes: int, dtype) -> torch.Tensor:
    """v4's [NW·Σc, W] gather one-hots built from an index stack (a lane past
    the window is an all-zero row)."""
    us = stack.reshape(-1, lanes).long()
    return (us[:, :, None] == torch.arange(window, device=stack.device)).to(dtype).reshape(
        -1, window)


# ---------------------------------------------------------------------------
# The tool.
# ---------------------------------------------------------------------------


def ablation_operands(params: dict, batch: dict, prec) -> dict:
    """Every form's operands for a slot batch with no spill tail (the JAX
    tool's ``common``, ``:782-843``), and the geometry: ``slot_stack``,
    ``slot_pstack``, ``h0``, ``prev0``, ``s0``, ``skip0``, ``skip_w``,
    ``proj_w``, ``a_next``, ``glue_w``, ``glue_wx``, ``s0x``,
    ``onehot_tiles``, ``pool_gl``, ``pred_hd``, ``window``, ``slots``,
    ``num_heads``, ``num_layers``, ``gmax``, ``prefix_caps`` (v3's) and
    ``caps_v4`` (v4's and v5's)."""
    from ..models import base
    from ..models.gat import _project, _raw_features, _scores, megakernel_operands

    cdt = prec.compute_dtype
    L, H, D = params["proj_w"].shape[:3]
    hd = H * D
    window, n_slots = (int(x) for x in batch["slot_geom"].shape[-2:])
    if batch["slot_spill"].shape[-1]:
        raise ValueError("the ablation takes a slot batch with no spill tail")
    prev = _raw_features(params, batch, prec)
    n = prev.shape[0]
    h = _project(params["proj_w"][0], prev, prec)
    s0 = torch.cat([_scores(h, params["a_src"][0], prec),
                    _scores(h, params["a_tgt"][0], prec)], 1).to(cdt)
    ops = megakernel_operands(params, prec)
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    pcaps = base.slot_prefix_caps(batch, n_slots)
    caps_v4 = pcaps or (window,) * n_slots
    stack_v4 = batch["slot_pstack"] if pcaps else batch["slot_stack"]
    glue_wx, s0x = expand_score_operands(ops["glue_w"], s0, hd, H)
    return dict(
        slot_stack=batch["slot_stack"], slot_pstack=stack_v4, h0=h.reshape(n, hd).contiguous(),
        prev0=prev.reshape(n, hd).contiguous(), s0=s0.contiguous(),
        skip0=(prev.reshape(n, hd).to(acc) @ ops["skip0_w"].to(acc)).to(cdt),
        skip_w=ops["skip_w"], proj_w=ops["proj_w"], a_next=ops["a_next"], glue_w=ops["glue_w"],
        glue_wx=glue_wx, s0x=s0x, onehot_tiles=onehot_tiles(stack_v4, window, sum(caps_v4), cdt),
        pool_gl=batch["pool_gl"], pred_hd=ops["pred_hd"], window=window, slots=n_slots,
        num_heads=H, num_layers=L, gmax=base.POOL_GMAX, prefix_caps=pcaps, caps_v4=caps_v4,
    )


def row5_operands(k: dict) -> dict:
    """``gat_mega_ablate``'s r5 operands from row 5's own
    (``models.gat.slot_kernel_operands``, ``gat_local_model_slots``'
    keywords)."""
    geom = {n: k[n] for n in ("window", "slots", "num_heads", "num_layers", "gmax",
                               "prefix_caps", "pool_gl", "pred_hd", "h0", "proj_w")}
    return dict(geom, stack=k["slot_pstack"], x0=k["skip0"], s0=None, w=k["skip_w"],
                a_next=k["a_all"])


def form_operands(form: str, c: dict) -> dict:
    """``gat_mega_ablate``'s keyword operands of ``form`` from
    ``ablation_operands``' dict ``c`` (r5: from ``c["row5"]``, row 5's)."""
    if form == "r5":
        return row5_operands(c["row5"])
    geom = {k: c[k] for k in ("window", "slots", "num_heads", "num_layers", "gmax")}
    common = dict(h0=c["h0"], pool_gl=c["pool_gl"], pred_hd=c["pred_hd"], **geom)
    if form == "v1":
        return dict(common, stack=c["slot_stack"], x0=c["prev0"], s0=c["s0"], w=c["skip_w"],
                    proj_w=c["proj_w"], a_next=c["a_next"])
    caps = c["prefix_caps"] if form == "v3" else c["caps_v4"]
    if form == "v3" and caps is None:
        raise ValueError("v3 takes the prefix-compacted stack")
    stack = c["onehot_tiles"] if form == "v4" else c["slot_pstack"]
    s0, w = (c["s0x"], c["glue_wx"]) if form == "v5" else (c["s0"], c["glue_w"])
    return dict(common, stack=stack, x0=c["skip0"], s0=s0, w=w, prefix_caps=caps)


def parse_row(name: str) -> tuple:
    """A ``--variants`` entry → (form, variant): ``full`` … ``addcat`` are
    v1's, ``v3`` / ``v3:<stage>`` and so on the other forms'."""
    if name.split(":")[0] in ("v3", "v4", "v5", "r5"):
        form, _, stage = name.partition(":")
        return form, stage or "full"
    return "v1", name


def row_fn(name: str, c: dict):
    """A zero-argument callable running one row of the table on ``c``."""
    from ..ops.local_layer import gat_local_model_slots

    if name == "noop":
        return lambda: c["h0"] * 0 + 1
    if name in ("slots", "dense"):
        return lambda: gat_local_model_slots(**c["row5"])
    form, variant = parse_row(name)
    ops = form_operands(form, c)
    _flags(form, variant)
    return lambda: gat_mega_ablate(form, variant, **ops)


def print_table(rows: list, window: int, slots: int, graphs: int, reps: int) -> None:
    """The JAX tool's table: seconds per pass, noop subtracted, Δ to full."""
    times = dict(rows)
    noop, full = times["noop"], times.get("full")
    print(f"window={window} slots={slots} graphs={graphs} "
          f"reps={reps} (us/pass, noop-subtracted; Δfull)")
    for name, t in rows:
        delta = f"  Δ{(full - t) * 1e6:+9.1f}" if full is not None and name != "noop" else ""
        print(f"  {name:9s} {t * 1e6:9.1f}  dev {(t - noop) * 1e6:9.1f}{delta}")


def molhiv_bucket(graphs: int, window: int | None, device, node_capacity: int = 32768):
    """The GAT molhiv bucket of ``graphs`` synthetic graphs in the slot
    layout at ``window`` (default ``choose_geometry``'s), on ``device``: one
    bucket of ``node_capacity`` nodes holds them all."""
    from ..core.graphs import auto_edge_capacity, pack_dataset
    from ..core.synthetic import synthetic_dataset
    from ..models import base, registry

    spec = registry.get("gat")
    gs = registry.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=graphs))
    window = window or base.choose_geometry("gat", max(g.num_nodes for g in gs))[0]
    (bucket,) = pack_dataset(gs, node_capacity=node_capacity,
                             edge_capacity=auto_edge_capacity(gs, node_capacity),
                             graph_capacity=2048, align_window=window)
    return base.to_device(base.as_batch(bucket, blocked="local_slots", window=window), device)


def main(argv=None) -> None:
    from ..core.numerics import BF16
    from ..models.gat import slot_kernel_operands
    from ..params.loaders import params_from_numpy, synthetic_gat_params
    from .matmul_shapes import best_seconds, tool_device
    from .timing import graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--graphs", type=int, default=1028)
    ap.add_argument("--ell-window", type=int, default=None,
                    help="the slot window: 128..1024 rows in whole blocks of 128")
    ap.add_argument("--variants", default="slots,dense,full,noexp,nogather,noexpand,noglue,nopool")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("# every form runs row 5's kernel body (csrc/gat_model.cuh) with that form's "
          "operands and rounding points")
    device = tool_device(args.device)
    batch = molhiv_bucket(args.graphs, args.ell_window, device)
    params = params_from_numpy(synthetic_gat_params(0), BF16, device)
    c = ablation_operands(params, batch, BF16)
    names = args.variants.split(",")
    if {"slots", "dense"} & set(names) or any(n.startswith("r5") for n in names):
        c["row5"] = slot_kernel_operands(params, batch, BF16)
        print("# slots and dense both run row 5's kernel (gat_local_model_slots): the JAX "
              "package's slot and dense megakernels compute its function")
    if device.type == "cuda":  # device time: the launches replayed from a CUDA graph
        seconds = lambda fn: min(graph_ms(fn, args.reps) for _ in range(args.trials)) / 1e3
    else:
        seconds = lambda fn: best_seconds(fn, args.reps, args.trials, device)
    rows = [(name, seconds(row_fn(name, c))) for name in ["noop"] + names]
    print_table(rows, c["window"], c["slots"], args.graphs, args.reps)


if __name__ == "__main__":
    main()
