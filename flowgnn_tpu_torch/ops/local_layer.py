"""Graph-local kernels over the slot and ELL layouts.

Each wrapper here is the counterpart of one TPU kernel of
``flowgnn_tpu/ops/pallas/local_layer.py``. The whole-model kernels run a
whole model (L layers plus the pooled prediction head) in one launch per
bucket. Over the degree-sorted slot layout, one block per window of 128
rows:

- ``gin_local_model_slots``: GIN / GIN-VN (``csrc/gin_local_model_slots.cu``);
- ``gcn_local_model_slots``: GCN (``csrc/gcn_local_model_slots.cu``);
- ``pna_local_model``: PNA's conv stack and readout MLP-1
  (``csrc/pna_local_model.cu``);
- ``dgn_local_model``: DGN's conv stack and readout MLP-1
  (``csrc/dgn_local_model.cu``);
- ``gat_local_model_slots``: GAT (``csrc/gat_local_model_slots.cu``), the
  one kernel behind the JAX package's three GAT megakernels
  (``gat_local_model_pairs``, ``gat_local_model_slots``,
  ``gat_local_model_dense``), which compute the same function; it follows
  the numerics of the default, ``gat_local_model_pairs``.

Over the k=1 ELL layout, one thread-block cluster per window of 128 to 1024
rows (128 rows per block):

- ``gin_local_model``: GIN / GIN-VN (``csrc/gin_local_model.cu``);
- ``gcn_local_model``: GCN (``csrc/gcn_local_model.cu``).

The per-layer slot kernels run one layer per launch, over a slot batch with
a spill tail (or one the whole-model kernel does not take), one block per
window of 128 rows:

- ``pna_local_stats_ell``: PNA's four aggregates
  (``csrc/pna_local_stats_slots.cu``);
- ``dgn_local_layer_slots``: a whole DGN layer, with the spill tail's
  pre-reduced channels (``csrc/dgn_local_layer_slots.cu``);
- ``gat_local_message_slots``: GAT's softmax sums or messages
  (``csrc/gat_local_message_slots.cu``).

The spill tail's scatter is ``ops.spmm.windowed_segment_sum``.

On a CUDA tensor a wrapper launches its hand-written kernel, or raises; on a
CPU tensor it runs its ``_ref``, the same function in plain torch, which the
CPU tests hold against the JAX kernel. Each launch adds one to the wrapper's
``launches`` count.

The TPU kernels' ``wps`` (windows per grid step), ``_pad_slot_operands`` and
``_ablate`` stage stubs are not carried over: they batch TPU grid steps to
amortize MXU weight loads, or attribute TPU time, and the Hopper kernels run
one block, or one cluster, per window. Nor is ``_ell_meta``'s recentred
bfloat16 lane metadata: it halves the TPU's index tiles, and the ELL kernels
here take int32 (u, v, three bond rows) per lane.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import load_library

# Every CUDA source of the port (``csrc/<name>.cu``), this module's kernels
# and ``ops.spmm``'s.
LIBRARIES = (
    "gin_local_model_slots", "gcn_local_model_slots", "pna_local_model",
    "dgn_local_model", "gat_local_model_slots", "gin_local_model",
    "gcn_local_model", "pna_local_stats_slots", "dgn_local_layer_slots",
    "gat_local_message_slots", "windowed_segment_sum",
)


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


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float64 if dt == torch.float64 else torch.float32


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` zero-padded along its first axis to ``rows`` rows."""
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def _meta_lanes(slot_meta, nw: int, sw: int, window: int, vocab: int):
    """Per prefix lane of ``slot_meta``: (the window-row gather index over
    the padded node axis, the bool valid mask [NW·Σc, 1], the three bond
    table rows with −1 mapped to the zero row ``vocab``)."""
    meta = slot_meta.reshape(nw, sw, 4).long()
    src = meta[..., 0] + _center(window)
    valid = ((src >= 0) & (src < window)).reshape(-1, 1)
    win = torch.arange(nw, device=slot_meta.device)[:, None]
    gather = (win * window + src.clamp(0, window - 1)).reshape(-1)
    attrs = meta[..., 1:].reshape(-1, 3)
    return gather, valid, torch.where(attrs >= 0, attrs, vocab)


def _accumulate(msg: torch.Tensor, caps, offs, nw: int, window: int) -> torch.Tensor:
    """Per-lane messages [NW·Σc, D] → per-row sums [NW·W, D], slot by slot
    (row r of slot k is lane offs[k] + r): the order the kernels sum in."""
    d = msg.shape[-1]
    msg = msg.reshape(nw, -1, d)
    acc = torch.zeros(nw, window, d, dtype=msg.dtype, device=msg.device)
    for k, c in enumerate(caps):
        acc[:, :c] += msg[:, offs[k] : offs[k] + c]
    return acc.reshape(nw * window, d)


def _pool_index(pool_gl: torch.Tensor, nw: int, window: int, gmax: int) -> torch.Tensor:
    """Each padded row's slot in a [NW·(GMAX+1)] per-window graph table
    whose last slot per window is a sink for padding rows."""
    win = torch.arange(nw, device=pool_gl.device)[:, None]
    gl = pool_gl.long().reshape(nw, window).clamp(max=gmax)
    return (win * (gmax + 1) + gl).reshape(-1)


def _pool_sums(p: torch.Tensor, pool_gl: torch.Tensor, nw: int, window: int,
               gmax: int) -> torch.Tensor:
    """Per-row head outputs [NW·W, T] → [NW·GMAX, T] per-window graph sums
    (``_pool_epilogue``)."""
    t_out = p.shape[1]
    pool = torch.zeros(nw * (gmax + 1), t_out, dtype=p.dtype, device=p.device)
    pool.index_add_(0, _pool_index(pool_gl, nw, window, gmax), p)
    return pool.reshape(nw, gmax + 1, t_out)[:, :gmax].reshape(nw * gmax, t_out)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def _slot_lanes(slot_src: torch.Tensor, caps, window: int, slots: int) -> list:
    """Per slot k of a [NW·W, S] ``slot_src``: (each row's source row over
    the padded node axis, the bool valid mask [NW·W, 1]). Slot k counts for
    the rows below caps[k] whose source is not the sentinel W."""
    rows = slot_src.shape[0]
    row_in_win = torch.arange(rows, device=slot_src.device) % window
    win_base = torch.arange(rows, device=slot_src.device) - row_in_win
    src = slot_src.long()
    lanes = []
    for k in range(slots):
        sk = src[:, k]
        ok = (sk < window) & (row_in_win < min(caps[k], window))
        lanes.append((win_base + sk.clamp(max=window - 1), ok[:, None]))
    return lanes


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _slot_lanes_of_meta(slot_meta, nw: int, window: int, vocab: int, caps, offs, acc):
    """The slot layout as lanes (see ``_gin_model_ref``): every prefix lane
    of ``slot_meta``; an empty lane reads a zero source and its message is
    dropped; row r of slot k is lane offs[k] + r."""
    gather, valid, attr_rows = _meta_lanes(slot_meta, nw, sum(caps), window, vocab)
    valid = valid.to(acc)
    return gather, valid, attr_rows, lambda msg: _accumulate(msg * valid, caps, offs, nw, window)


def _ell_lanes(ell_meta, nw: int, window: int, vocab: int, acc):
    """The ELL layout as lanes (see ``_gin_model_ref``): ``ell_meta``
    [NW·B, 5] holds per lane (u, v, three bond-table rows), both endpoints
    in-window. As in the TPU kernel's one-hot gather and scatter, a lane
    whose u lies outside [0, W) reads a zero source and one whose v does
    lands nowhere; messages are summed per destination row in lane order."""
    meta = ell_meta.long().reshape(nw, -1, 5)
    base = torch.arange(nw, device=ell_meta.device)[:, None] * window
    u, v = meta[..., 0], meta[..., 1]
    u_ok = ((u >= 0) & (u < window)).reshape(-1, 1).to(acc)
    gather = (base + u.clamp(0, window - 1)).reshape(-1)
    v_ok = ((v >= 0) & (v < window)).reshape(-1)
    dest = (base + v.clamp(0, window - 1)).reshape(-1)[v_ok]
    attrs = meta[..., 2:].reshape(-1, 3)
    attrs = torch.where((attrs >= 0) & (attrs < vocab), attrs, vocab)

    def accumulate(msg: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(nw * window, msg.shape[1], dtype=msg.dtype, device=msg.device)
        return out.index_add_(0, dest, msg[v_ok])

    return gather, u_ok, attrs, accumulate


def _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
                   eps_all, pred_w, window, num_layers, gmax, vn_col) -> torch.Tensor:
    """GIN / GIN-VN over a layout's ``lanes`` = (per lane: the source's row
    over the padded node axis, the source's validity [lanes, 1], the three
    bond-table rows with the zero row ``vocab`` for none; and the function
    that sums per-lane messages into per-row sums [NW·W, D])."""
    gather, u_ok, attr_rows, accumulate = lanes
    cdt = h0.dtype
    acc = _acc_dtype(cdt)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    vocab = ee_tables.shape[0] // num_layers
    hid = w1_all.shape[0] // num_layers

    h = _padded(h0, nw * window)
    pool_idx = _pool_index(pool_gl, nw, window, gmax)
    vnc = None
    if vn_col is not None:
        vnc = _padded(vn_col.to(acc)[:, None], nw * window)

    for l in range(num_layers):
        tab = torch.cat([
            ee_tables[l * vocab : (l + 1) * vocab].to(acc),
            torch.zeros(1, d, dtype=acc, device=dev),
        ])
        hf = h.to(acc)
        ee = tab[attr_rows[:, 0]] + tab[attr_rows[:, 1]] + tab[attr_rows[:, 2]]
        agg = accumulate(_relu(hf[gather] * u_ok + ee).to(cdt).to(acc))
        if vnc is not None:
            e0 = tab[0] + tab[5] + tab[11]  # the (0, 0, 0)-attr bond embedding
            r = _relu(hf + e0).to(cdt).to(acc)
            rcat = torch.cat([r * (1 - vnc), r * vnc], dim=1)
            pooled = torch.zeros(nw * (gmax + 1), 2 * d, dtype=acc, device=dev)
            pooled.index_add_(0, pool_idx, rcat)
            pooled[gmax :: gmax + 1] = 0  # padding rows pool nothing
            back = pooled[pool_idx]
            agg = agg + back[:, d:] * (1 - vnc) + back[:, :d] * vnc
        act = (agg + eps_all[l, 0].to(acc) * hf).to(cdt)
        w1 = w1_all[l * hid : (l + 1) * hid].to(acc)
        w2 = w2_all[l * d : (l + 1) * d].to(acc)
        z = _relu(act.to(acc) @ w1.T + b1_all[l].to(acc)).to(cdt)
        out = z.to(acc) @ w2.T + b2_all[l].to(acc)
        if l != num_layers - 1:
            out = _relu(out)
        h = out.to(cdt)

    return _pool_sums(h.to(acc) @ pred_w.to(acc), pool_gl, nw, window, gmax)


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
    caps, offs, _ = _slot_prefix_geom(prefix_caps, window, slots)
    lanes = _slot_lanes_of_meta(slot_meta, -(-h0.shape[0] // window), window,
                                ee_tables.shape[0] // num_layers, caps, offs,
                                _acc_dtype(h0.dtype))
    return _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                          b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col)


def gin_local_model_ref(
    ell_meta: torch.Tensor,  # [NW·B, 5] int (u_local, v_local, attrs+offsets)
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
    num_layers: int,
    gmax: int,
    vn_col: Optional[torch.Tensor] = None,  # [n] analytic-VN flag (GIN-VN)
) -> torch.Tensor:
    """Plain-torch ``gin_local_model`` (the k=1 ELL layout, B lanes per
    window): [NW·GMAX, T] pool sums. Numerics as in
    ``gin_local_model_slots_ref``; messages are summed per destination row
    in lane order."""
    lanes = _ell_lanes(ell_meta, -(-h0.shape[0] // window), window,
                       ee_tables.shape[0] // num_layers, _acc_dtype(h0.dtype))
    return _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                          b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col)


def _gcn_model_ref(lanes, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                   wn_all, bn_all, pred_w, window, num_layers, gmax) -> torch.Tensor:
    """GCN after conv 0 over a layout's ``lanes`` (as in ``_gin_model_ref``)."""
    gather, u_ok, attr_rows, accumulate = lanes
    cdt = h0.dtype
    acc = _acc_dtype(cdt)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    vocab = ee_tables.shape[0] // num_layers

    h = _padded(h0, nw * window)
    dis_v = _padded(dis.to(acc)[:, None], nw * window)
    dis_u = dis_v[gather] * u_ok  # layer-invariant source norm
    zero_row = torch.zeros(1, d, dtype=acc, device=dev)
    for l in range(num_layers):
        tab = torch.cat([ee_tables[l * vocab : (l + 1) * vocab].to(acc), zero_row])
        hf = h.to(acc)
        ee = tab[attr_rows[:, 0]] + tab[attr_rows[:, 1]] + tab[attr_rows[:, 2]]
        msg = (dis_u * _relu(hf[gather] + ee)).to(cdt).to(acc)
        a = accumulate(msg) * dis_v + _relu(hf + roots[l].to(acc)) * (dis_v * dis_v)
        x = alphas[l].to(acc) * a + betas[l].to(acc)
        if l == num_layers - 1:
            break
        wn = wn_all[l * d : (l + 1) * d].to(acc)
        h = (_relu(x).to(cdt).to(acc) @ wn + bn_all[l].to(acc)).to(cdt)

    p = x.to(cdt).to(acc) @ pred_w.to(acc)
    return _pool_sums(p, pool_gl, nw, window, gmax)


def gcn_local_model_slots_ref(
    slot_meta: torch.Tensor,  # [NW·Σc, 4] int (src − W/2 ‖ attrs+offsets)
    h0: torch.Tensor,  # [n, D] conv-0 output
    dis: torch.Tensor,  # [n] 1/sqrt(out_deg + 1), in h0's dtype
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    ee_tables: torch.Tensor,  # [L·13, D] stacked bond-embedding tables
    roots: torch.Tensor,  # [L, D] root embeddings
    alphas: torch.Tensor,  # [L, D] folded-BN scale
    betas: torch.Tensor,  # [L, D] folded-BN shift
    wn_all: torch.Tensor,  # [(L-1)·D, D] next conv weights, [in, out] blocks
    bn_all: torch.Tensor,  # [L-1, D] next conv biases
    pred_w: torch.Tensor,  # [D, T]
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """Plain-torch ``gcn_local_model_slots``: [NW·GMAX, T] pool sums.

    Per layer l: msg = rnd(dis_u·relu(h_u + ee_l)) per slot lane, acc = the
    slot-ordered sum of msg per row, a = acc·dis_v + relu(h_v + root_l)·
    dis_v², x = alpha_l·a + beta_l; between layers h = rnd(rnd(relu(x))·wn_l
    + bn_l); the head pools rnd(x)·pred_w of the last layer (no relu).
    ``rnd`` rounds to h0's dtype; products and sums run in f32 (f64 for f64
    inputs)."""
    caps, offs, _ = _slot_prefix_geom(prefix_caps, window, slots)
    lanes = _slot_lanes_of_meta(slot_meta, -(-h0.shape[0] // window), window,
                                ee_tables.shape[0] // num_layers, caps, offs,
                                _acc_dtype(h0.dtype))
    return _gcn_model_ref(lanes, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                          wn_all, bn_all, pred_w, window, num_layers, gmax)


def gcn_local_model_ref(
    ell_meta: torch.Tensor,  # [NW·B, 5] int (u_local, v_local, attrs+offsets)
    h0: torch.Tensor,  # [n, D] conv-0 output
    dis: torch.Tensor,  # [n] 1/sqrt(out_deg + 1), in h0's dtype
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    ee_tables: torch.Tensor,  # [L·13, D] stacked bond-embedding tables
    roots: torch.Tensor,  # [L, D] root embeddings
    alphas: torch.Tensor,  # [L, D] folded-BN scale
    betas: torch.Tensor,  # [L, D] folded-BN shift
    wn_all: torch.Tensor,  # [(L-1)·D, D] next conv weights, [in, out] blocks
    bn_all: torch.Tensor,  # [L-1, D] next conv biases
    pred_w: torch.Tensor,  # [D, T]
    window: int,
    num_layers: int,
    gmax: int,
) -> torch.Tensor:
    """Plain-torch ``gcn_local_model`` (the k=1 ELL layout): [NW·GMAX, T]
    pool sums. Numerics as in ``gcn_local_model_slots_ref``, with dis_u
    gathered once; messages are summed per destination row in lane order."""
    lanes = _ell_lanes(ell_meta, -(-h0.shape[0] // window), window,
                       ee_tables.shape[0] // num_layers, _acc_dtype(h0.dtype))
    return _gcn_model_ref(lanes, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                          wn_all, bn_all, pred_w, window, num_layers, gmax)


def pna_local_model_ref(
    slot_src: torch.Tensor,  # [NW·W, S] int in-window sources (sentinel W)
    h0: torch.Tensor,  # [n, D] embedded input features
    inv_deg: torch.Tensor,  # [n] 1/max(in_deg, 1)
    t: torch.Tensor,  # [n] log(out_deg + 1)/avg_deg scaler
    scale: torch.Tensor,  # [n] avg_deg/log(out_deg + 1) scaler
    w_all: torch.Tensor,  # [L·4D, 3D] per layer [w_noneᵀ ‖ w_tᵀ ‖ w_scaleᵀ]
    b_all: torch.Tensor,  # [L, D]
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    mlp1_w: torch.Tensor,  # [D, T] readout MLP-1 (right-multiplied)
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    min_init: float,  # seed of the running min (the upper ap_fixed extreme)
    max_init: float,  # seed of the running max (the lower extreme)
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """Plain-torch ``pna_local_model``: [NW·GMAX, T] pool sums of h·mlp1_w.

    Per layer, per row: the sum, sum of squares, min and max of h over the
    row's valid slot sources (slot k counts for rows below caps[k]; min/max
    start at their seeds, so a row with no source keeps them), mean =
    s·invd, std = sqrt(max(q·invd − mean², 0)), the tower y = [mean | min |
    max | std]·w_l with each part rounded to h0's dtype, acc = y_none +
    t·y_t + scale·y_scale + b_l, and h = rnd(h + relu(acc)). Products and
    sums run in f32 (f64 for f64 inputs)."""
    cdt = h0.dtype
    acc = _acc_dtype(cdt)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, _ = _slot_prefix_geom(prefix_caps, window, slots)
    rows = nw * window

    h = _padded(h0, rows)
    invd, t_w, sc_w = (_padded(v.to(acc)[:, None], rows) for v in (inv_deg, t, scale))
    lanes = _slot_lanes(slot_src, caps, window, slots)
    for l in range(num_layers):
        hf = h.to(acc)
        s = torch.zeros(rows, d, dtype=acc, device=dev)
        q = torch.zeros_like(s)
        mn = torch.full_like(s, min_init)
        mx = torch.full_like(s, max_init)
        for gather, ok in lanes:
            x = hf[gather]
            s = s + torch.where(ok, x, 0.0)
            q = q + torch.where(ok, x * x, 0.0)
            mn = torch.minimum(mn, torch.where(ok, x, min_init))
            mx = torch.maximum(mx, torch.where(ok, x, max_init))
        mean = s * invd
        std = torch.sqrt(_relu(q * invd - mean * mean))
        stats = torch.cat([mean, mn, mx, std], dim=1).to(cdt).to(acc)
        y = stats @ w_all[l * 4 * d : (l + 1) * 4 * d].to(acc)
        a = y[:, :d] + t_w * y[:, d : 2 * d] + sc_w * y[:, 2 * d :] + b_all[l].to(acc)
        h = (hf + _relu(a)).to(cdt)

    return _pool_sums(h.to(acc) @ mlp1_w.to(acc), pool_gl, nw, window, gmax)


def dgn_local_model_ref(
    slot_src: torch.Tensor,  # [NW·W, S] int in-window sources (sentinel W)
    h0: torch.Tensor,  # [n, D] embedded input features
    eig: torch.Tensor,  # [n] Fiedler-vector entry, in h0's dtype
    inv_deg: torch.Tensor,  # [n] 1/max(out_deg, 1)
    eigw_sum: torch.Tensor,  # [n] Σ over in-edges of eig_u − eig_v
    inv_abssum: torch.Tensor,  # [n] 1/Σ|eig_u − eig_v| (zero → 1/EIG_EPS)
    w_all: torch.Tensor,  # [L·2D, D] per layer [mean rows ‖ directional rows]
    b_all: torch.Tensor,  # [L, D]
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    mlp1_w: torch.Tensor,  # [D, T] readout MLP-1 (right-multiplied)
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """Plain-torch ``dgn_local_model``: [NW·GMAX, T] pool sums of h·mlp1_w.

    Per layer, per row v over its valid slot sources u, in slot order:
    m1 = Σ h_u and m2 = Σ e_u·h_u − e_v·m1 (the TPU kernel's factoring of
    Σ (e_u − e_v)·h_u), a1 = m1·inv_deg, a2 = |m2 − eigw_sum·h_v|·
    inv_abssum, y = [rnd(a1) | rnd(a2)]·w_l + b_l and h = rnd(h + relu(y)).
    ``rnd`` rounds to h0's dtype; products and sums run in f32 (f64 for f64
    inputs)."""
    cdt = h0.dtype
    acc = _acc_dtype(cdt)
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, _ = _slot_prefix_geom(prefix_caps, window, slots)
    rows = nw * window

    h = _padded(h0, rows)
    e_v, invd, ews, inva = (
        _padded(v.to(acc)[:, None], rows) for v in (eig, inv_deg, eigw_sum, inv_abssum)
    )
    lanes = [(gather, ok, e_v[gather]) for gather, ok in _slot_lanes(slot_src, caps, window, slots)]
    for l in range(num_layers):
        hf = h.to(acc)
        m1 = torch.zeros(rows, d, dtype=acc, device=h0.device)
        m2 = torch.zeros_like(m1)
        for gather, ok, e_u in lanes:
            x = torch.where(ok, hf[gather], 0.0)
            m1 = m1 + x
            m2 = m2 + e_u * x
        m2 = m2 - e_v * m1
        a = torch.cat([m1 * invd, (m2 - ews * hf).abs() * inva], dim=1)
        y = a.to(cdt).to(acc) @ w_all[l * 2 * d : (l + 1) * 2 * d].to(acc)
        h = (hf + _relu(y + b_all[l].to(acc))).to(cdt)

    return _pool_sums(h.to(acc) @ mlp1_w.to(acc), pool_gl, nw, window, gmax)


def gat_local_model_slots_ref(
    slot_pstack: torch.Tensor,  # [NW·Σc] int prefix-compacted sources (sentinel W)
    h0: torch.Tensor,  # [n, H·D] layer-0 projection, head-major
    skip0: torch.Tensor,  # [n, H·D] layer-0 skip term, in h0's dtype
    proj_w: torch.Tensor,  # [(L-1)·HD, HD] right-mul projections, layers 1..L-1
    skip_w: torch.Tensor,  # [(L-1)·HD, HD] right-mul skip weights, layers 1..L-1
    a_all: torch.Tensor,  # [L·HD, 2H] per-layer score maps [a_src ‖ a_tgt]
    pool_gl: torch.Tensor,  # [NW·W] int graph-local ids (GMAX = padding)
    pred_hd: torch.Tensor,  # [HD, T] head average ∘ prediction head
    window: int,
    slots: int,
    num_heads: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """Plain-torch ``gat_local_model_slots``: [NW·GMAX, T] pool sums.

    Per layer: [s_src ‖ s_tgt] = h·a_l from the rounded h (f32, not
    rounded); per valid lane (u → v) and head k, score = exp(leaky(s_src[v]
    + s_tgt[u], 0.2)) with no max subtraction (a sentinel lane contributes
    nothing, whatever its score); msg = rnd(Σ score·h_u / Σ score), a zero
    denominator taken as 1. Between layers feat = rnd(ELU(msg + skip)),
    h = rnd(feat·proj_{l+1}) and skip = feat·skip_{l+1} (kept unrounded);
    the head pools rnd(msg + skip)·pred_hd. ``rnd`` rounds to h0's dtype;
    products and sums run in f32 (f64 for f64 inputs)."""
    cdt = h0.dtype
    acc = _acc_dtype(cdt)
    dev = h0.device
    n, hd = h0.shape
    nh = num_heads
    nw = -(-n // window)
    caps, offs, sw = _slot_prefix_geom(prefix_caps, window, slots)
    rows = nw * window
    rnd = lambda x: x.to(cdt).to(acc)
    per_head = lambda x: x.repeat_interleave(hd // nh, dim=1)  # [., H] → [., HD]

    h = _padded(h0, rows).to(acc)
    skip = _padded(skip0, rows).to(acc)
    src = slot_pstack.long().reshape(nw, sw)
    win = torch.arange(nw, device=dev)[:, None] * window
    # Per lane: its destination row (lane offs[k] + r is row r) and source row.
    dest = torch.cat([torch.arange(c, device=dev) for c in caps]).expand(nw, sw)
    dest = (win + dest).reshape(-1)
    gather = (win + src.clamp(max=window - 1)).reshape(-1)
    valid = (src < window).reshape(-1, 1)
    for l in range(num_layers):
        s = h @ a_all[l * hd : (l + 1) * hd].to(acc)
        raw = s[dest, :nh] + s[gather, nh:]
        score = torch.where(valid, torch.exp(torch.where(raw < 0, raw * 0.2, raw)), 0.0)
        num = _accumulate(per_head(score) * h[gather], caps, offs, nw, window)
        den = _accumulate(score, caps, offs, nw, window)
        msg = rnd(num / per_head(torch.where(den == 0, 1.0, den)))
        if l == num_layers - 1:
            break
        x = msg + skip
        feat = rnd(torch.where(x <= 0, torch.exp(x) - 1, x))
        h = rnd(feat @ proj_w[l * hd : (l + 1) * hd].to(acc))
        skip = feat @ skip_w[l * hd : (l + 1) * hd].to(acc)

    return _pool_sums(rnd(msg + skip) @ pred_hd.to(acc), pool_gl, nw, window, gmax)


def pna_local_stats_ell_ref(
    slot_src: torch.Tensor,  # [NW·W, S] int in-window sources (sentinel W)
    h: torch.Tensor,  # [n, D]
    window: int,
    slots: int,
    min_init: float,  # seed of the running min (the upper ap_fixed extreme)
    max_init: float,  # seed of the running max (the lower extreme)
) -> torch.Tensor:
    """Plain-torch ``pna_local_stats_ell``: [n, 4D] per destination row, over
    its valid slot sources u in slot order, [Σ h_u ‖ Σ h_u² ‖ min ‖ max] in
    h's dtype. An empty slot adds nothing to the sums and leaves min / max at
    their seeds. Sums run in f32 (f64 for f64 inputs)."""
    acc = _acc_dtype(h.dtype)
    n, d = h.shape
    rows = -(-n // window) * window
    hf = _padded(h, rows).to(acc)
    s = torch.zeros(rows, d, dtype=acc, device=h.device)
    q = torch.zeros_like(s)
    mn = torch.full_like(s, min_init)
    mx = torch.full_like(s, max_init)
    for gather, ok in _slot_lanes(slot_src, (window,) * slots, window, slots):
        x = hf[gather]
        s = s + torch.where(ok, x, 0.0)
        q = q + torch.where(ok, x * x, 0.0)
        mn = torch.minimum(mn, torch.where(ok, x, min_init))
        mx = torch.maximum(mx, torch.where(ok, x, max_init))
    return torch.cat([s, q, mn, mx], dim=1)[:n].to(h.dtype)


def dgn_local_layer_slots_ref(
    slot_src: torch.Tensor,  # [NW·W, S] int in-window sources (sentinel W)
    h: torch.Tensor,  # [n, D]
    eig: torch.Tensor,  # [n] Fiedler-vector entry
    inv_deg: torch.Tensor,  # [n] 1/max(out_deg, 1)
    eigw_sum: torch.Tensor,  # [n] Σ over in-edges of eig_u − eig_v
    inv_abssum: torch.Tensor,  # [n] 1/Σ|eig_u − eig_v| (zero → 1/EIG_EPS)
    w_post: torch.Tensor,  # [2D, D] posttrans, right-multiplied
    b_post: torch.Tensor,  # [1, D]
    window: int,
    slots: int,
    m_spill: Optional[torch.Tensor] = None,  # [n, 2D] spill tail's [m1 ‖ m2]
) -> torch.Tensor:
    """Plain-torch ``dgn_local_layer_slots``: the next h [n, D] in h's dtype.

    Per row v over its valid slot sources u, in slot order: m1 = Σ h_u and
    m2 = Σ e_u·h_u − e_v·m1; then ``m_spill``'s halves are added (its m2
    half is already weighted), a1 = m1·inv_deg, a2 = |m2 − eigw_sum·h_v|·
    inv_abssum, y = rnd([a1 ‖ a2])·w_post + b_post and h' = rnd(h +
    relu(y)). The four node terms are rounded to h's dtype first, as the
    TPU kernel's feature tile carries them. ``rnd`` rounds to h's dtype;
    products and sums run in f32 (f64 for f64 inputs)."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    n, d = h.shape
    rows = -(-n // window) * window
    hf = _padded(h, rows).to(acc)
    e_v, invd, ews, inva = (
        _padded(v.to(cdt).to(acc)[:, None], rows) for v in (eig, inv_deg, eigw_sum, inv_abssum)
    )
    m1 = torch.zeros(rows, d, dtype=acc, device=h.device)
    m2 = torch.zeros_like(m1)
    for gather, ok in _slot_lanes(slot_src, (window,) * slots, window, slots):
        x = torch.where(ok, hf[gather], 0.0)
        m1 = m1 + x
        m2 = m2 + e_v[gather] * x
    m2 = m2 - e_v * m1
    if m_spill is not None:
        sp = _padded(m_spill.to(acc), rows)
        m1 = m1 + sp[:, :d]
        m2 = m2 + sp[:, d:]
    a = torch.cat([m1 * invd, (m2 - ews * hf).abs() * inva], dim=1)
    y = a.to(cdt).to(acc) @ w_post.to(acc) + b_post.to(acc)
    return (hf + _relu(y)).to(cdt)[:n]


def gat_local_message_slots_ref(
    slot_stack: torch.Tensor,  # [NW·S·W] int dest-major sources (sentinel W)
    h: torch.Tensor,  # [n, H·D] projected features, head-major
    s_src: torch.Tensor,  # [n, H] destination scores
    s_tgt: torch.Tensor,  # [n, H] source scores
    window: int,
    slots: int,
    num_heads: int,
    divide: bool = True,
) -> torch.Tensor:
    """Plain-torch ``gat_local_message_slots``: per destination row v and
    head k, over its valid slot sources u in slot order, score =
    exp(leaky(s_src[v] + s_tgt[u], 0.2)) with s_tgt rounded to h's dtype,
    num = Σ score·h_u and den = Σ score. An empty slot adds nothing, whatever
    its score would be (the TPU kernel multiplies exp(raw) by the slot's
    validity, which turns an overflowing empty lane into NaN). ``divide``:
    [n, H·D] num / den, a zero den taken as 1; else [n, H·D + H] [num ‖
    den]; both in h's dtype. Sums run in f32 (f64 for f64 inputs)."""
    acc = _acc_dtype(h.dtype)
    n, hd = h.shape
    dh = hd // num_heads
    nw = -(-n // window)
    rows = nw * window
    hf = _padded(h, rows).to(acc)
    st = _padded(s_tgt.to(h.dtype), rows).to(acc)
    ss = _padded(s_src, rows).to(acc)
    src = slot_stack.long().reshape(nw, slots, window)
    gather = torch.arange(nw, device=h.device)[:, None, None] * window + src.clamp(max=window - 1)
    valid = src < window
    num = torch.zeros(rows, hd, dtype=acc, device=h.device)
    den = torch.zeros(rows, num_heads, dtype=acc, device=h.device)
    for k in range(slots):
        g = gather[:, k].reshape(-1)
        raw = ss + st[g]
        score = torch.where(
            valid[:, k].reshape(-1, 1), torch.exp(torch.where(raw < 0, raw * 0.2, raw)), 0.0
        )
        num = num + score.repeat_interleave(dh, dim=1) * hf[g]
        den = den + score
    if divide:
        out = num / torch.where(den == 0, 1.0, den).repeat_interleave(dh, dim=1)
    else:
        out = torch.cat([num, den], dim=1)
    return out[:n].to(h.dtype)


# ---------------------------------------------------------------------------
# The kernels: build, bind, check, launch.
# ---------------------------------------------------------------------------

_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_INT_P = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _library(name: str) -> dict:
    """The C functions of ``csrc/<name>.cu``'s built library, signatures
    declared, by suffix: every library exports ``<prefix>_smem_optin``,
    ``_smem_bytes``, ``_launch`` and ``_error_string``; a slot library
    ``_max_d`` and ``_max_slots``, an ELL library ``_max_d``,
    ``_rows_per_block`` and ``_max_cluster``."""
    slot_getters = ("max_d", "max_slots")
    ell_getters = ("max_d", "rows_per_block", "max_cluster")
    prefix, getters, smem_args, launch_args = {
        "gin_local_model_slots": (
            "gin_slots", slot_getters, [_I32] * 5 + [_INT_P, _I32],
            [_I32] + [_PTR] * 12 + [_I32] * 10 + [_INT_P, _I32, _I32, _PTR],
        ),
        "gcn_local_model_slots": (
            "gcn_slots", slot_getters, [_I32] * 5 + [_INT_P, _I32],
            [_I32] + [_PTR] * 12 + [_I32] * 9 + [_INT_P, _I32, _I32, _PTR],
        ),
        "pna_local_model": (
            "pna_model", slot_getters, [_I32] * 5,
            [_I32] + [_PTR] * 10 + [_I32] * 7 + [_F32, _F32, _INT_P, _I32, _I32, _PTR],
        ),
        "dgn_local_model": (
            "dgn_model", slot_getters, [_I32] * 5,
            [_I32] + [_PTR] * 11 + [_I32] * 7 + [_INT_P, _I32, _I32, _PTR],
        ),
        "gat_local_model_slots": (
            "gat_slots", slot_getters, [_I32] * 6,
            [_I32] + [_PTR] * 9 + [_I32] * 8 + [_INT_P, _I32, _I32, _PTR],
        ),
        "gin_local_model": (
            "gin_ell", ell_getters, [_I32] * 4,
            [_I32] + [_PTR] * 12 + [_I32] * 10 + [_I32, _PTR],
        ),
        "gcn_local_model": (
            "gcn_ell", ell_getters, [_I32] * 4,
            [_I32] + [_PTR] * 12 + [_I32] * 9 + [_I32, _PTR],
        ),
        "pna_local_stats_slots": (
            "pna_stats", slot_getters, [_I32] * 3,
            [_I32] + [_PTR] * 3 + [_I32] * 5 + [_F32, _F32, _I32, _PTR],
        ),
        "dgn_local_layer_slots": (
            "dgn_layer", slot_getters, [_I32] * 3,
            [_I32] + [_PTR] * 10 + [_I32] * 5 + [_I32, _PTR],
        ),
        "gat_local_message_slots": (
            "gat_msg", slot_getters, [_I32] * 4,
            [_I32] + [_PTR] * 5 + [_I32] * 7 + [_I32, _PTR],
        ),
        "windowed_segment_sum": (
            "wss", (), [_I32],
            [_I32] + [_PTR] * 4 + [_I32] * 5 + [_I32, _PTR],
        ),
    }[name]
    lib = load_library(name)
    fns = {}
    for suffix, args, res in (
        *((g, [], _I32) for g in getters),
        ("smem_optin", [_I32], _I64), ("smem_bytes", smem_args, _I64),
        ("launch", launch_args, _I32), ("error_string", [_I32], ctypes.c_char_p),
    ):
        f = getattr(lib, f"{prefix}_{suffix}")
        f.argtypes, f.restype = args, res
        fns[suffix] = f
    return fns


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_geometry(lib, d: int, slots: int, caps, window: int, smem: int, dev) -> None:
    """Raise before launch on what a slot kernel's tile or the card's
    shared memory cannot take."""
    if any(c > window for c in caps):
        raise ValueError(f"prefix caps {caps} exceed the window {window}")
    if not 1 <= slots <= lib["max_slots"]():
        raise ValueError(f"slots={slots} outside 1..{lib['max_slots']()}")
    _check_smem(lib, d, window, smem, dev)


def _check_ell_geometry(lib, d: int, window: int, smem: int, dev) -> None:
    """Raise before launch on a window an ELL kernel's cluster cannot span
    (whole blocks of ``rows_per_block`` rows, at most ``max_cluster`` of
    them) or what its tile or the card's shared memory cannot take."""
    rows, most = lib["rows_per_block"](), lib["max_cluster"]()
    if window % rows or not 1 <= window // rows <= most:
        raise ValueError(
            f"window {window} is not 1..{most} whole blocks of {rows} rows"
        )
    _check_smem(lib, d, window, smem, dev)


def _check_smem(lib, d: int, window: int, smem: int, dev) -> None:
    if "max_d" in lib and d > lib["max_d"]():
        raise ValueError(f"D={d} exceeds the kernel's tile ({lib['max_d']()})")
    limit = lib["smem_optin"](dev.index)
    if limit < 0:
        raise RuntimeError(lib["error_string"](int(-limit)).decode())
    if smem > limit:
        raise ValueError(
            f"window {window} × D {d} needs {smem} B of shared memory per "
            f"block; this card allows {limit} B"
        )


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib['error_string'](rc).decode()}")


def _dtype_code(dt: torch.dtype) -> int:
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h0: dtype {dt}; the kernel takes float32 or bfloat16")
    return 0 if dt == torch.float32 else 1


def _dispatch(h0: torch.Tensor, ref, launch, args):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if h0.device.type == "cpu":
        return ref(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return launch(*args)


def _check_gin(h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all, eps_all,
               pred_w, vn_col, window, num_layers) -> tuple[int, int, int]:
    """Check the GIN kernels' common operands; returns (vocab, H, T)."""
    dt, dev = h0.dtype, h0.device
    n, d = h0.shape
    L = num_layers
    vocab = ee_tables.shape[0] // L
    hid = w1_all.shape[0] // L
    t_out = pred_w.shape[1]
    _check("h0", h0, dt, (n, d), dev)
    _check("pool_gl", pool_gl, torch.int32, (-(-n // window) * window,), dev)
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
    return vocab, hid, t_out


def _launch_gin(slot_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
                eps_all, pred_w, window, slots, num_layers, gmax, prefix_caps,
                vn_col) -> torch.Tensor:
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, sw = _slot_prefix_geom(prefix_caps, window, slots)
    L = num_layers
    vocab, hid, t_out = _check_gin(h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                                   b2_all, eps_all, pred_w, vn_col, window, L)
    _check("slot_meta", slot_meta, torch.int32, (nw * sw, 4), dev)

    lib = _library("gin_local_model_slots")
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    smem = lib["smem_bytes"](window, d, vocab, gmax, t_out, caps_arr, slots)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_meta.data_ptr(), h0.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), w1_all.data_ptr(), b1_all.data_ptr(),
        w2_all.data_ptr(), b2_all.data_ptr(), eps_all.data_ptr(),
        pred_w.data_ptr(), None if vn_col is None else vn_col.data_ptr(),
        out.data_ptr(),
        nw, n, window, _center(window), d, hid, L, vocab, gmax, t_out,
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gin_local_model_slots")
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
    return _dispatch(h0, gin_local_model_slots_ref, _launch_gin, args)


gin_local_model_slots.launches = 0


def _check_gcn(h0, dis, pool_gl, ee_tables, roots, alphas, betas, wn_all, bn_all,
               pred_w, window, num_layers) -> tuple[int, int]:
    """Check the GCN kernels' common operands; returns (vocab, T)."""
    dt, dev = h0.dtype, h0.device
    n, d = h0.shape
    L = num_layers
    vocab = ee_tables.shape[0] // L
    t_out = pred_w.shape[1]
    _check("h0", h0, dt, (n, d), dev)
    _check("dis", dis, dt, (n,), dev)
    _check("pool_gl", pool_gl, torch.int32, (-(-n // window) * window,), dev)
    _check("ee_tables", ee_tables, dt, (L * vocab, d), dev)
    for name, x in (("roots", roots), ("alphas", alphas), ("betas", betas)):
        _check(name, x, dt, (L, d), dev)
    _check("wn_all", wn_all, dt, ((L - 1) * d, d), dev)
    _check("bn_all", bn_all, dt, (L - 1, d), dev)
    _check("pred_w", pred_w, dt, (d, t_out), dev)
    return vocab, t_out


def _launch_gcn(slot_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                wn_all, bn_all, pred_w, window, slots, num_layers, gmax,
                prefix_caps) -> torch.Tensor:
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, sw = _slot_prefix_geom(prefix_caps, window, slots)
    L = num_layers
    vocab, t_out = _check_gcn(h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                              wn_all, bn_all, pred_w, window, L)
    _check("slot_meta", slot_meta, torch.int32, (nw * sw, 4), dev)

    lib = _library("gcn_local_model_slots")
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    smem = lib["smem_bytes"](window, d, vocab, gmax, t_out, caps_arr, slots)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_meta.data_ptr(), h0.data_ptr(), dis.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), roots.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), wn_all.data_ptr(), bn_all.data_ptr(),
        pred_w.data_ptr(), out.data_ptr(),
        nw, n, window, _center(window), d, L, vocab, gmax, t_out,
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gcn_local_model_slots")
    gcn_local_model_slots.launches += 1
    return out


def gcn_local_model_slots(
    slot_meta: torch.Tensor,
    h0: torch.Tensor,
    dis: torch.Tensor,
    pool_gl: torch.Tensor,
    ee_tables: torch.Tensor,
    roots: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    wn_all: torch.Tensor,
    bn_all: torch.Tensor,
    pred_w: torch.Tensor,
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """GCN whole-model slot megakernel: [NW·GMAX, T] f32 per-window pool
    sums. Operands as in ``gcn_local_model_slots_ref``; a CPU tensor runs
    the plain version, a CUDA tensor launches the kernel (float32 or
    bfloat16 activations, norms and weights, int32 ``slot_meta`` /
    ``pool_gl``) or raises. Each launch adds one to
    ``gcn_local_model_slots.launches``."""
    args = (slot_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
            wn_all, bn_all, pred_w, window, slots, num_layers, gmax, prefix_caps)
    return _dispatch(h0, gcn_local_model_slots_ref, _launch_gcn, args)


gcn_local_model_slots.launches = 0


def _ell_block(ell_meta: torch.Tensor, nw: int, dev) -> int:
    """Checks ``ell_meta``; returns its lanes per window (k=1: one block)."""
    lanes = ell_meta.shape[0]
    if lanes % nw:
        raise ValueError(f"ell_meta: {lanes} lanes are not {nw} equal window blocks")
    _check("ell_meta", ell_meta, torch.int32, (lanes, 5), dev)
    return lanes // nw


def _launch_gin_ell(ell_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
                    eps_all, pred_w, window, num_layers, gmax, vn_col) -> torch.Tensor:
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    L = num_layers
    vocab, hid, t_out = _check_gin(h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                                   b2_all, eps_all, pred_w, vn_col, window, L)
    block = _ell_block(ell_meta, nw, dev)

    lib = _library("gin_local_model")
    _check_ell_geometry(lib, d, window, lib["smem_bytes"](d, vocab, gmax, t_out), dev)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        ell_meta.data_ptr(), h0.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), w1_all.data_ptr(), b1_all.data_ptr(),
        w2_all.data_ptr(), b2_all.data_ptr(), eps_all.data_ptr(),
        pred_w.data_ptr(), None if vn_col is None else vn_col.data_ptr(),
        out.data_ptr(),
        nw, n, window, block, d, hid, L, vocab, gmax, t_out,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gin_local_model")
    gin_local_model.launches += 1
    return out


def gin_local_model(
    ell_meta: torch.Tensor,
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
    num_layers: int,
    gmax: int,
    vn_col: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GIN / GIN-VN whole-model ELL kernel: [NW·GMAX, T] f32 per-window
    pool sums over the k=1 ELL layout, at windows of 128 up to 1024 rows.

    Operands as in ``gin_local_model_ref``. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (float32 or bfloat16
    activations and weights, int32 ``ell_meta`` / ``pool_gl``, float32
    ``eps_all``) or raises. Each launch adds one to
    ``gin_local_model.launches``."""
    args = (ell_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
            eps_all, pred_w, window, num_layers, gmax, vn_col)
    return _dispatch(h0, gin_local_model_ref, _launch_gin_ell, args)


gin_local_model.launches = 0


def _launch_gcn_ell(ell_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                    wn_all, bn_all, pred_w, window, num_layers, gmax) -> torch.Tensor:
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    L = num_layers
    vocab, t_out = _check_gcn(h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                              wn_all, bn_all, pred_w, window, L)
    block = _ell_block(ell_meta, nw, dev)

    lib = _library("gcn_local_model")
    _check_ell_geometry(lib, d, window, lib["smem_bytes"](d, vocab, gmax, t_out), dev)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        ell_meta.data_ptr(), h0.data_ptr(), dis.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), roots.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), wn_all.data_ptr(), bn_all.data_ptr(),
        pred_w.data_ptr(), out.data_ptr(),
        nw, n, window, block, d, L, vocab, gmax, t_out,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gcn_local_model")
    gcn_local_model.launches += 1
    return out


def gcn_local_model(
    ell_meta: torch.Tensor,
    h0: torch.Tensor,
    dis: torch.Tensor,
    pool_gl: torch.Tensor,
    ee_tables: torch.Tensor,
    roots: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    wn_all: torch.Tensor,
    bn_all: torch.Tensor,
    pred_w: torch.Tensor,
    window: int,
    num_layers: int,
    gmax: int,
) -> torch.Tensor:
    """GCN whole-model ELL kernel (after conv 0): [NW·GMAX, T] f32
    per-window pool sums over the k=1 ELL layout, at windows of 128 up to
    1024 rows. Operands as in ``gcn_local_model_ref``; a CPU tensor runs the
    plain version, a CUDA tensor launches the kernel (float32 or bfloat16
    activations, norms and weights, int32 ``ell_meta`` / ``pool_gl``) or
    raises. Each launch adds one to ``gcn_local_model.launches``."""
    args = (ell_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
            wn_all, bn_all, pred_w, window, num_layers, gmax)
    return _dispatch(h0, gcn_local_model_ref, _launch_gcn_ell, args)


gcn_local_model.launches = 0


def _launch_pna(slot_src, h0, inv_deg, t, scale, w_all, b_all, pool_gl, mlp1_w,
                window, slots, num_layers, gmax, min_init, max_init,
                prefix_caps) -> torch.Tensor:
    dt = h0.dtype
    code = _dtype_code(dt)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, _ = _slot_prefix_geom(prefix_caps, window, slots)
    L = num_layers
    t_out = mlp1_w.shape[1]
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h0", h0, dt, (n, d), dev)
    for name, x in (("inv_deg", inv_deg), ("t", t), ("scale", scale)):
        _check(name, x, dt, (n,), dev)
    _check("w_all", w_all, dt, (L * 4 * d, 3 * d), dev)
    _check("b_all", b_all, dt, (L, d), dev)
    _check("pool_gl", pool_gl, torch.int32, (nw * window,), dev)
    _check("mlp1_w", mlp1_w, dt, (d, t_out), dev)

    lib = _library("pna_local_model")
    smem = lib["smem_bytes"](window, d, gmax, t_out, slots)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_src.data_ptr(), h0.data_ptr(), inv_deg.data_ptr(), t.data_ptr(),
        scale.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
        pool_gl.data_ptr(), mlp1_w.data_ptr(), out.data_ptr(),
        nw, n, window, d, L, gmax, t_out, float(min_init), float(max_init),
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "pna_local_model")
    pna_local_model.launches += 1
    return out


def pna_local_model(
    slot_src: torch.Tensor,
    h0: torch.Tensor,
    inv_deg: torch.Tensor,
    t: torch.Tensor,
    scale: torch.Tensor,
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    pool_gl: torch.Tensor,
    mlp1_w: torch.Tensor,
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    min_init: float,
    max_init: float,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """PNA whole-model slot megakernel (conv stack + readout MLP-1):
    [NW·GMAX, T] f32 per-window pool sums. Operands as in
    ``pna_local_model_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 activations, scalers
    and weights, int32 ``slot_src`` / ``pool_gl``) or raises. Each launch
    adds one to ``pna_local_model.launches``."""
    args = (slot_src, h0, inv_deg, t, scale, w_all, b_all, pool_gl, mlp1_w,
            window, slots, num_layers, gmax, min_init, max_init, prefix_caps)
    return _dispatch(h0, pna_local_model_ref, _launch_pna, args)


pna_local_model.launches = 0


def _launch_dgn(slot_src, h0, eig, inv_deg, eigw_sum, inv_abssum, w_all, b_all,
                pool_gl, mlp1_w, window, slots, num_layers, gmax,
                prefix_caps) -> torch.Tensor:
    dt = h0.dtype
    code = _dtype_code(dt)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, _ = _slot_prefix_geom(prefix_caps, window, slots)
    L = num_layers
    t_out = mlp1_w.shape[1]
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h0", h0, dt, (n, d), dev)
    for name, x in (("eig", eig), ("inv_deg", inv_deg), ("eigw_sum", eigw_sum),
                    ("inv_abssum", inv_abssum)):
        _check(name, x, dt, (n,), dev)
    _check("w_all", w_all, dt, (L * 2 * d, d), dev)
    _check("b_all", b_all, dt, (L, d), dev)
    _check("pool_gl", pool_gl, torch.int32, (nw * window,), dev)
    _check("mlp1_w", mlp1_w, dt, (d, t_out), dev)

    lib = _library("dgn_local_model")
    smem = lib["smem_bytes"](window, d, gmax, t_out, slots)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_src.data_ptr(), h0.data_ptr(), eig.data_ptr(), inv_deg.data_ptr(),
        eigw_sum.data_ptr(), inv_abssum.data_ptr(), w_all.data_ptr(),
        b_all.data_ptr(), pool_gl.data_ptr(), mlp1_w.data_ptr(), out.data_ptr(),
        nw, n, window, d, L, gmax, t_out,
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_model")
    dgn_local_model.launches += 1
    return out


def dgn_local_model(
    slot_src: torch.Tensor,
    h0: torch.Tensor,
    eig: torch.Tensor,
    inv_deg: torch.Tensor,
    eigw_sum: torch.Tensor,
    inv_abssum: torch.Tensor,
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    pool_gl: torch.Tensor,
    mlp1_w: torch.Tensor,
    window: int,
    slots: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """DGN whole-model slot megakernel (conv stack + readout MLP-1):
    [NW·GMAX, T] f32 per-window pool sums. Operands as in
    ``dgn_local_model_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 activations, per-node
    terms and weights, int32 ``slot_src`` / ``pool_gl``) or raises. Each
    launch adds one to ``dgn_local_model.launches``."""
    args = (slot_src, h0, eig, inv_deg, eigw_sum, inv_abssum, w_all, b_all,
            pool_gl, mlp1_w, window, slots, num_layers, gmax, prefix_caps)
    return _dispatch(h0, dgn_local_model_ref, _launch_dgn, args)


dgn_local_model.launches = 0


def _launch_gat(slot_pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl, pred_hd,
                window, slots, num_heads, num_layers, gmax,
                prefix_caps) -> torch.Tensor:
    dt = h0.dtype
    code = _dtype_code(dt)
    dev = h0.device
    n, hd = h0.shape
    nw = -(-n // window)
    caps, _, sw = _slot_prefix_geom(prefix_caps, window, slots)
    L, nh = num_layers, num_heads
    t_out = pred_hd.shape[1]
    if hd % nh:
        raise ValueError(f"H·D={hd} is not a multiple of the {nh} heads")
    _check("slot_pstack", slot_pstack, torch.int32, (nw * sw,), dev)
    _check("h0", h0, dt, (n, hd), dev)
    _check("skip0", skip0, dt, (n, hd), dev)
    _check("proj_w", proj_w, dt, ((L - 1) * hd, hd), dev)
    _check("skip_w", skip_w, dt, ((L - 1) * hd, hd), dev)
    _check("a_all", a_all, dt, (L * hd, 2 * nh), dev)
    _check("pool_gl", pool_gl, torch.int32, (nw * window,), dev)
    _check("pred_hd", pred_hd, dt, (hd, t_out), dev)

    lib = _library("gat_local_model_slots")
    smem = lib["smem_bytes"](window, hd, nh, gmax, t_out, sw)
    _check_geometry(lib, hd, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_pstack.data_ptr(), h0.data_ptr(), skip0.data_ptr(), proj_w.data_ptr(),
        skip_w.data_ptr(), a_all.data_ptr(), pool_gl.data_ptr(),
        pred_hd.data_ptr(), out.data_ptr(),
        nw, n, window, hd, nh, L, gmax, t_out,
        caps_arr, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gat_local_model_slots")
    gat_local_model_slots.launches += 1
    return out


def gat_local_model_slots(
    slot_pstack: torch.Tensor,
    h0: torch.Tensor,
    skip0: torch.Tensor,
    proj_w: torch.Tensor,
    skip_w: torch.Tensor,
    a_all: torch.Tensor,
    pool_gl: torch.Tensor,
    pred_hd: torch.Tensor,
    window: int,
    slots: int,
    num_heads: int,
    num_layers: int,
    gmax: int,
    prefix_caps: tuple | None = None,
) -> torch.Tensor:
    """GAT whole-model slot megakernel: [NW·GMAX, T] f32 per-window pool
    sums. Operands as in ``gat_local_model_slots_ref``; a CPU tensor runs
    the plain version, a CUDA tensor launches the kernel (float32 or
    bfloat16 activations and weights, int32 ``slot_pstack`` / ``pool_gl``)
    or raises. Each launch adds one to ``gat_local_model_slots.launches``."""
    args = (slot_pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl, pred_hd,
            window, slots, num_heads, num_layers, gmax, prefix_caps)
    return _dispatch(h0, gat_local_model_slots_ref, _launch_gat, args)


gat_local_model_slots.launches = 0


def _launch_pna_stats(slot_src, h, window, slots, min_init, max_init) -> torch.Tensor:
    code = _dtype_code(h.dtype)
    dev = h.device
    n, d = h.shape
    nw = -(-n // window)
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h", h, h.dtype, (n, d), dev)

    lib = _library("pna_local_stats_slots")
    _check_geometry(lib, d, slots, (window,), window, lib["smem_bytes"](window, d, slots), dev)
    out = torch.empty((n, 4 * d), dtype=h.dtype, device=dev)
    rc = lib["launch"](
        code, slot_src.data_ptr(), h.data_ptr(), out.data_ptr(),
        nw, n, window, d, slots, float(min_init), float(max_init),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "pna_local_stats_ell")
    pna_local_stats_ell.launches += 1
    return out


def pna_local_stats_ell(
    slot_src: torch.Tensor,
    h: torch.Tensor,
    window: int,
    slots: int,
    min_init: float,
    max_init: float,
) -> torch.Tensor:
    """PNA's four slot aggregates of one layer: [n, 4D] [sum ‖ sum² ‖ min ‖
    max] in h's dtype (``csrc/pna_local_stats_slots.cu``, the counterpart of
    the TPU kernel ``pna_local_stats_ell``, which also runs over the slot
    layout). Operands as in ``pna_local_stats_ell_ref``; note the order of
    the seeds: the PNA model passes (MAX_INIT, MIN_INIT), the min's seed
    first. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (float32 or bfloat16 h, int32 ``slot_src``) or raises. Each
    launch adds one to ``pna_local_stats_ell.launches``."""
    args = (slot_src, h, window, slots, min_init, max_init)
    return _dispatch(h, pna_local_stats_ell_ref, _launch_pna_stats, args)


pna_local_stats_ell.launches = 0


def _launch_dgn_layer(slot_src, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post,
                      window, slots, m_spill) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    nw = -(-n // window)
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h", h, dt, (n, d), dev)
    for name, x in (("eig", eig), ("inv_deg", inv_deg), ("eigw_sum", eigw_sum),
                    ("inv_abssum", inv_abssum)):
        _check(name, x, dt, (n,), dev)
    _check("w_post", w_post, dt, (2 * d, d), dev)
    _check("b_post", b_post, dt, (1, d), dev)
    if m_spill is not None:
        _check("m_spill", m_spill, dt, (n, 2 * d), dev)

    lib = _library("dgn_local_layer_slots")
    _check_geometry(lib, d, slots, (window,), window, lib["smem_bytes"](window, d, slots), dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, slot_src.data_ptr(), h.data_ptr(), eig.data_ptr(), inv_deg.data_ptr(),
        eigw_sum.data_ptr(), inv_abssum.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
        None if m_spill is None else m_spill.data_ptr(), out.data_ptr(),
        nw, n, window, d, slots, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_layer_slots")
    dgn_local_layer_slots.launches += 1
    return out


def dgn_local_layer_slots(
    slot_src: torch.Tensor,
    h: torch.Tensor,
    eig: torch.Tensor,
    inv_deg: torch.Tensor,
    eigw_sum: torch.Tensor,
    inv_abssum: torch.Tensor,
    w_post: torch.Tensor,
    b_post: torch.Tensor,
    window: int,
    slots: int,
    m_spill: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One whole DGN layer over the slot layout: the next h [n, D] in h's
    dtype (``csrc/dgn_local_layer_slots.cu``). Operands as in
    ``dgn_local_layer_slots_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h, node terms,
    weights and ``m_spill``, int32 ``slot_src``) or raises. Each launch adds
    one to ``dgn_local_layer_slots.launches``."""
    args = (slot_src, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post,
            window, slots, m_spill)
    return _dispatch(h, dgn_local_layer_slots_ref, _launch_dgn_layer, args)


dgn_local_layer_slots.launches = 0


def _launch_gat_message(slot_stack, h, s_src, s_tgt, window, slots, num_heads,
                        divide) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, hd = h.shape
    nw = -(-n // window)
    if hd % num_heads:
        raise ValueError(f"H·D={hd} is not a multiple of the {num_heads} heads")
    _check("slot_stack", slot_stack, torch.int32, (nw * slots * window,), dev)
    _check("h", h, dt, (n, hd), dev)
    _check("s_src", s_src, dt, (n, num_heads), dev)
    _check("s_tgt", s_tgt, dt, (n, num_heads), dev)

    lib = _library("gat_local_message_slots")
    smem = lib["smem_bytes"](window, hd, num_heads, slots)
    _check_geometry(lib, hd, slots, (window,), window, smem, dev)
    out = torch.empty((n, hd if divide else hd + num_heads), dtype=dt, device=dev)
    rc = lib["launch"](
        code, slot_stack.data_ptr(), h.data_ptr(), s_src.data_ptr(), s_tgt.data_ptr(),
        out.data_ptr(), nw, n, window, hd, num_heads, slots, int(bool(divide)),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gat_local_message_slots")
    gat_local_message_slots.launches += 1
    return out


def gat_local_message_slots(
    slot_stack: torch.Tensor,
    h: torch.Tensor,
    s_src: torch.Tensor,
    s_tgt: torch.Tensor,
    window: int,
    slots: int,
    num_heads: int,
    divide: bool = True,
) -> torch.Tensor:
    """GAT's edge softmax of one layer over the slot layout: [n, H·D]
    (``divide``) or [n, H·D + H] in h's dtype
    (``csrc/gat_local_message_slots.cu``). Operands as in
    ``gat_local_message_slots_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h and scores, int32
    ``slot_stack``) or raises. Each launch adds one to
    ``gat_local_message_slots.launches``."""
    args = (slot_stack, h, s_src, s_tgt, window, slots, num_heads, divide)
    return _dispatch(h, gat_local_message_slots_ref, _launch_gat_message, args)


gat_local_message_slots.launches = 0
