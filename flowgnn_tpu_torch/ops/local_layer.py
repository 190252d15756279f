"""Graph-local kernels over the slot and ELL layouts.

Each wrapper here is the counterpart of one TPU kernel of
``flowgnn_tpu/ops/pallas/local_layer.py``. The whole-model kernels run a
whole model (L layers plus the pooled prediction head) in one launch per
bucket. Over the degree-sorted slot layout:

- ``gin_local_model_slots``: GIN / GIN-VN (``csrc/gin_local_model_slots.cu``),
  one thread-block cluster per window of 128 to 1024 rows, the kernel of
  ``gin_local_model`` below with the slot message stage
  (``csrc/gin_model.cuh``);
- ``gcn_local_model_slots``: GCN (``csrc/gcn_local_model_slots.cu``), the
  kernel of ``gcn_local_model`` below with the slot message stage
  (``csrc/gcn_model.cuh``);
- ``pna_local_model``: PNA's conv stack and readout MLP-1
  (``csrc/pna_local_model.cu``);
- ``dgn_local_model``: DGN's conv stack and readout MLP-1
  (``csrc/dgn_local_model.cu``);
- ``gat_local_model_slots``: GAT (``csrc/gat_local_model_slots.cu``), the
  one kernel behind the JAX package's three GAT megakernels
  (``gat_local_model_pairs``, ``gat_local_model_slots``,
  ``gat_local_model_dense``), which compute the same function; it follows
  the numerics of the default, ``gat_local_model_pairs``;

each one thread-block cluster of W/128 blocks per window of 128 to 1024
rows. The two GIN kernels share ``csrc/gin_model.cuh``, the two GCN kernels
``csrc/gcn_model.cuh``, and both the lane walks of ``csrc/lanes.cuh``; GAT's
body is ``csrc/gat_model.cuh``, whose four other forms are the megakernel
ablation's (``bench.ablate_gat_mega``).

Over the k=1 ELL layout, one thread-block cluster per window of 128 to 1024
rows (128 rows per block):

- ``gin_local_model``: GIN / GIN-VN (``csrc/gin_local_model.cu``);
- ``gcn_local_model``: GCN (``csrc/gcn_local_model.cu``).

The per-layer slot kernels run one layer per launch, over a slot batch with
a spill tail (or one the whole-model kernel does not take):

- ``pna_local_stats_ell``: PNA's four aggregates
  (``csrc/pna_local_stats_slots.cu``: the stats-only form of
  ``pna_local_model``'s kernel, ``csrc/pna_model.cuh``);
- ``dgn_local_layer_slots``: a whole DGN layer, with the spill tail's
  pre-reduced channels (``csrc/dgn_local_layer_slots.cu``), the one-layer
  form of ``dgn_local_model``'s kernel (``csrc/dgn_model.cuh``);
- ``gat_local_message_slots``: GAT's softmax sums or messages
  (``csrc/gat_local_message_slots.cu``: the message walk of
  ``gat_local_message_ell``, ``csrc/gat_messages.cuh``, over the slot
  rows), one block per 128 rows of a window of 128 to 1024 rows;
- ``pna_local_layer``: a whole PNA layer over a slot batch with no spill
  tail (``csrc/pna_local_layer_slots.cu``), the one-layer form of
  ``pna_local_model``'s kernel (``csrc/pna_model.cuh``);

all but row 21 one thread-block cluster of W/128 blocks per window of 128 to
1024 rows, as the whole-model kernels.

The per-layer ELL kernels run one layer per launch over the ELL layout with
any number k of edge blocks per window (the k·B lanes of a window are one
run sorted by destination row), at windows of 128 up to 1024 rows, one block
per 128 rows (rows 18, 15, 14 and 16: a thread-block cluster of W/128 blocks
per window); h stays in device memory between layers:

- ``gin_local_layer_ell``: a whole GIN / GIN-VN layer, messages, the spill
  tail's pre-summed ``m_spill`` and the MLP (``csrc/gin_local_layer_ell.cu``,
  TPU ``local_scatter_apply_ell_attr`` with the ``gin_local_layer_ell``
  epilogue; ``_local_scatter_apply_ell_wps``, its ``wps`` > 1 form, computes
  the same function and is merged into it);
- ``gcn_local_message_ell``: GCN's norm-scaled message sum
  (``csrc/gcn_local_message_ell.cu``: the messages-only form of
  ``gcn_local_model``'s kernel, ``csrc/gcn_model.cuh``);
- ``gcn_local_layer_ell``: a whole GCN layer after its conv, up to the next
  conv's output (``csrc/gcn_local_layer_ell.cu``: the one-layer form of
  ``gcn_local_model``'s kernel, ``csrc/gcn_model.cuh``);
- ``dgn_local_layer_ell``: a whole DGN layer with no spill tail
  (``csrc/dgn_local_layer_ell_model.cu``: the one-layer form of
  ``dgn_local_model``'s kernel, ``csrc/dgn_model.cuh``, with the ELL lane
  walk), and ``dgn_local_message_ell``: DGN's two message channels, for
  the caller to merge a spill tail (``csrc/dgn_local_layer_ell.cu``: the
  channels-only form of the same kernel);
- ``gat_local_message_ell``: GAT's softmax sums, for the caller to merge a
  spill tail and divide (``csrc/gat_local_message_ell.cu``: the message walk
  of ``gat_local_layer_ell``, ``csrc/gat_messages.cuh``);
- ``gat_local_layer_ell``: a whole non-final GAT layer, the softmax sums,
  the spill tail's pre-reduced ``spill_both``, the divide, skip projection,
  ELU and the next layer's projection and scores
  (``csrc/gat_local_layer_ell.cu``);
- ``gin_local_layer_ell_lanes``: ``gin_local_layer_ell`` with each lane's
  bond embedding given from outside instead of summed from the table in the
  kernel (TPU ``local_scatter_apply_ell``; ``gin_local_layer_ell(ee=...)``
  reaches it);
- ``gin_local_message_ell``: GIN's message sum alone, the bond embedding
  summed in the kernel (TPU ``gin_local_message_ell``, the JAX halo branch's;
  ``csrc/gin_local_message_ell.cu``), and ``gin_local_message_ell_lanes``:
  the same with each lane's bond embedding given and ``m_spill`` added (TPU
  ``local_scatter_apply_ell`` with the ELL stage bench's pass-through
  epilogue; ``csrc/gin_local_message_lanes.cu``): the messages-only forms
  of ``gin_local_layer_ell``'s and ``gin_local_layer_ell_lanes``'s kernel
  (``csrc/gin_layer.cuh``).

Over the legacy dynamic-window local layout (``as_batch(blocked="local")``:
a window owns as many 128-lane blocks as its edges need, ``block_window``
names each block's window):

- ``gin_local_layer``: a whole GIN / GIN-VN layer with per-lane bond
  embeddings (TPU ``local_scatter_apply`` with the ``gin_local_layer``
  epilogue). It and ``gin_local_layer_ell_lanes`` are one kernel
  (``csrc/gin_local_layer_blocks.cu``): the same function, and the ELL grid
  is the case where every window owns the same number of lanes.

The spill tail's scatter is ``ops.spmm.windowed_segment_sum``; the fused
edge-block layer ``gin_layer_fused`` is in ``ops.fused_layer``.

The three GIN kernels of rows 1, 8 and 13 run their bf16 update MLP on the
tensor cores through one routine (``csrc/gin_mlp.cuh``: ``wgmma``, the
weights streamed in chunks of 32 hidden units through a ring of bulk copies)
and their f32 MLP as FMA on the CUDA cores. Rows 9, 2, 15, 3, 4, 5, 20, 22,
18 and 23 run their bf16 products (GCN's next conv, PNA's tower, DGN's
posttrans, GAT's glue and its fused layer's skip and projection) through
another, one product of 128 rows
(``csrc/linear_wgmma.cuh``, the weights in chunks of 32 input channels
through the same ring), and their f32 product as FMA. The weight chunks are
packed on the host once per weight set (``mlp_tiles``, ``gcn_conv_tiles``,
``pna_tower_tiles``, ``dgn_posttrans_tiles``, ``gat_glue_tiles``); each
wrapper picks the ring's depth by shape and records it as its ``stages``.

On a CUDA tensor a wrapper launches its hand-written kernel, or raises; on a
CPU tensor it runs its ``_ref``, the same function in plain torch, which the
CPU tests hold against the JAX kernel. Each launch adds one to the wrapper's
``launches`` count.

The TPU kernels' ``wps`` (windows per grid step) and ``_pad_slot_operands``
are not carried over: they batch TPU grid steps to amortize MXU weight
loads, and the Hopper kernels run one block, or one cluster, per window. Nor
is ``_ell_meta``'s recentred bfloat16 lane metadata: it halves the TPU's
index tiles, and the ELL kernels here take int32 (u, v, three bond rows) per
lane. The ``_ablate`` stage stubs of ``gin_local_model_slots`` are rows 1
and 8's ``knockout`` bits (``GIN_KNOCKOUTS``, each with its plain version,
timed by ``bench.ablate_gin_slots``); those of ``gat_local_model_pairs``
are a form of the GAT ablation library (``bench.ablate_gat_mega``'s ``r5``,
timed by ``bench.ablate_gat_pairs``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Optional

import torch

from .build import load_library
from .tiles import kmajor_tiles

# Every CUDA source of the port (``csrc/<name>.cu``), this module's kernels
# and ``ops.spmm``'s.
LIBRARIES = (
    "gin_local_model_slots", "gcn_local_model_slots", "pna_local_model",
    "dgn_local_model", "gat_local_model_slots", "gin_local_model",
    "gcn_local_model", "pna_local_stats_slots", "dgn_local_layer_slots",
    "gat_local_message_slots", "windowed_segment_sum", "gin_local_layer_ell",
    "gcn_local_message_ell", "gcn_local_layer_ell", "pna_local_layer_slots",
    "dgn_local_layer_ell", "gat_local_message_ell", "gin_local_layer_blocks",
    "gin_layer_fused", "gat_local_layer_ell", "dgn_local_layer_ell_model",
    "gin_local_message_ell", "gin_local_message_lanes",
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

    def accumulate(msg: torch.Tensor, first: bool = False) -> torch.Tensor:
        if first:
            return _window_lanes(msg * valid, nw, window)
        return _accumulate(msg * valid, caps, offs, nw, window)

    return gather, valid, attr_rows, accumulate


def _window_lanes(msg: torch.Tensor, nw: int, window: int) -> torch.Tensor:
    """Per-lane messages [NW·lanes, D] → [NW·W, D], row r the window's lane
    r (zero past the window's lanes): the GIN kernel's ``kNoAcc`` and the
    TPU stub's ``msg[:window]``."""
    d = msg.shape[-1]
    msg = msg.reshape(nw, -1, d)
    out = torch.zeros(nw, window, d, dtype=msg.dtype, device=msg.device)
    m = min(window, msg.shape[1])
    out[:, :m] = msg[:, :m]
    return out.reshape(nw * window, d)


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

    def accumulate(msg: torch.Tensor, first: bool = False) -> torch.Tensor:
        if first:  # a pad lane (v outside the window) lands nowhere
            return _window_lanes(msg * v_ok[:, None].to(msg.dtype), nw, window)
        out = torch.zeros(nw * window, msg.shape[1], dtype=msg.dtype, device=msg.device)
        return out.index_add_(0, dest, msg[v_ok])

    return gather, u_ok, attrs, accumulate


# ``csrc/gin_model.cuh``'s Dims::knockout bits (timing knockouts of rows 1
# and 8), by the TPU stub names (``gin_local_model_slots(_ablate=...)``);
# "ablation" knocks nothing out and selects the kernel that reads the bits
# (the stage splits' whole: that kernel's branches cost it time of its own).
GIN_KNOCKOUTS = {"nomlp": 1, "nomessages": 2, "nogather": 4, "nobond": 8, "noacc": 16,
                 "ablation": 32}
GIN_NEAR_ROWS = 8  # nogather's sources: the window's first rows


def _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
                   eps_all, pred_w, window, num_layers, gmax, vn_col,
                   knockout: int = 0) -> torch.Tensor:
    """GIN / GIN-VN over a layout's ``lanes`` = (per lane: the source's row
    over the padded node axis, the source's validity [lanes, 1], the three
    bond-table rows with the zero row ``vocab`` for none; and the function
    that sums per-lane messages into per-row sums [NW·W, D], or with
    ``first=True`` gives row r the window's lane r). ``knockout``: the
    ``GIN_KNOCKOUTS`` bits, each stage's stand-in as the kernel computes it
    (``csrc/gin_model.cuh``)."""
    gather, u_ok, attr_rows, accumulate = lanes
    off = lambda name: bool(knockout & GIN_KNOCKOUTS[name])
    if off("nogather"):
        u_ok = u_ok * (gather % window < GIN_NEAR_ROWS)[:, None].to(u_ok.dtype)
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
        if off("nobond"):
            ee = (attr_rows == 0).sum(1, keepdim=True).to(acc) * tab[0]
        else:
            ee = tab[attr_rows[:, 0]] + tab[attr_rows[:, 1]] + tab[attr_rows[:, 2]]
        msg = _relu(hf[gather] * u_ok + ee).to(cdt).to(acc)
        if off("nomessages"):
            agg = torch.zeros_like(hf)
        else:
            agg = accumulate(msg, first=off("noacc"))
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
        if off("nomlp"):
            h = act
            continue
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
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
    knockout: int = 0,  # GIN_KNOCKOUTS bits (timing stand-ins)
) -> torch.Tensor:
    """Plain-torch ``gin_local_model_slots``: [NW·GMAX, T] pool sums.

    Products and sums run in f32 (f64 when h0 is f64) and the activations
    are rounded to h0's dtype where the kernel rounds them. The result is
    f32, or f64 for f64 inputs (the kernel has no f64 mode). ``mlp_tiles``,
    the bf16 kernel's packed copy of W1 and W2, is not read. ``knockout``
    computes the stage stand-ins of ``GIN_KNOCKOUTS``: nogather, nobond,
    noacc and nomlp are the TPU kernel's ``_ablate`` stubs
    (``msg[:window]`` for noacc), nomessages drops the lane messages."""
    caps, offs, _ = _slot_prefix_geom(prefix_caps, window, slots)
    lanes = _slot_lanes_of_meta(slot_meta, -(-h0.shape[0] // window), window,
                                ee_tables.shape[0] // num_layers, caps, offs,
                                _acc_dtype(h0.dtype))
    return _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                          b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col, knockout)


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
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
    knockout: int = 0,  # GIN_KNOCKOUTS bits (timing stand-ins)
) -> torch.Tensor:
    """Plain-torch ``gin_local_model`` (the k=1 ELL layout, B lanes per
    window): [NW·GMAX, T] pool sums. Numerics and ``knockout`` as in
    ``gin_local_model_slots_ref`` (noacc: row r takes the window's lane r, a
    pad lane nothing); messages are summed per destination row in lane
    order."""
    lanes = _ell_lanes(ell_meta, -(-h0.shape[0] // window), window,
                       ee_tables.shape[0] // num_layers, _acc_dtype(h0.dtype))
    return _gin_model_ref(lanes, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                          b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col, knockout)


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
    conv_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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
    conv_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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
    tower_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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
    n, d = h0.shape
    nw = -(-n // window)
    caps, _, _ = _slot_prefix_geom(prefix_caps, window, slots)
    rows = nw * window

    h = _padded(h0, rows)
    invd, t_w, sc_w = (_padded(v.to(acc)[:, None], rows) for v in (inv_deg, t, scale))
    lanes = _slot_lanes(slot_src, caps, window, slots)
    for l in range(num_layers):
        h = _pna_layer(h.to(acc), lanes, invd, t_w, sc_w, w_all[l * 4 * d : (l + 1) * 4 * d],
                       b_all[l], min_init, max_init, cdt)

    return _pool_sums(h.to(acc) @ mlp1_w.to(acc), pool_gl, nw, window, gmax)


def _pna_layer(hf, lanes, invd, t_w, sc_w, w, b, min_init, max_init, cdt) -> torch.Tensor:
    """One PNA layer over slot ``lanes`` (as ``_slot_lanes`` gives them) of
    the padded h ``hf`` in the accumulation dtype: the four aggregates, mean
    and std, the tower y = rnd([mean | min | max | std])·w, acc = y_none +
    t·y_t + scale·y_scale + b and the next h rnd(h + relu(acc)), ``rnd``
    rounding to ``cdt``."""
    acc = hf.dtype
    d = hf.shape[1]
    s = torch.zeros_like(hf)
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
    y = stats @ w.to(acc)
    a = y[:, :d] + t_w * y[:, d : 2 * d] + sc_w * y[:, 2 * d :] + b.to(acc)
    return (hf + _relu(a)).to(cdt)


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
    posttrans_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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
    glue_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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


def pna_local_layer_ref(
    slot_src: torch.Tensor,  # [NW·W, S] int in-window sources (sentinel W)
    h: torch.Tensor,  # [n, D]
    inv_deg: torch.Tensor,  # [n] 1/max(in_deg, 1)
    t: torch.Tensor,  # [n] log(out_deg + 1)/avg_deg scaler
    scale: torch.Tensor,  # [n] avg_deg/log(out_deg + 1) scaler
    w_cat: torch.Tensor,  # [4D, 3D] [w_noneᵀ ‖ w_tᵀ ‖ w_scaleᵀ]
    b: torch.Tensor,  # [1, D]
    window: int,
    slots: int,
    min_init: float,  # seed of the running min (the upper ap_fixed extreme)
    max_init: float,  # seed of the running max (the lower extreme)
    tower_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``pna_local_layer``: one whole PNA layer over the slot
    layout, the next h [n, D] in h's dtype. One layer of
    ``pna_local_model_ref`` over every slot (no prefix caps), with the TPU
    kernel's rounding points: inv_deg, t and scale are rounded to h's dtype
    (they ride its feature tile), the aggregates are exact f32 sums of h_u,
    mean = s·invd, std = sqrt(max(q·invd − mean², 0)), the stats are rounded
    to h's dtype before the tower, acc = y₀ + t·y₁ + scale·y₂ + b in f32,
    and h' = rnd(h + relu(acc)). Products and sums run in f32 (f64 for f64
    inputs)."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    rows = -(-h.shape[0] // window) * window
    invd, t_w, sc_w = (_padded(v.to(cdt).to(acc)[:, None], rows) for v in (inv_deg, t, scale))
    lanes = _slot_lanes(slot_src, (window,) * slots, window, slots)
    out = _pna_layer(_padded(h, rows).to(acc), lanes, invd, t_w, sc_w, w_cat, b, min_init,
                     max_init, cdt)
    return out[: h.shape[0]]


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
    posttrans_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
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


def _ell_layer_inputs(ell_meta, h, ee_table, window):
    """The per-layer ELL kernels' common start: (lanes as ``_ell_lanes``
    gives them, h padded to NW·W rows in the accumulation dtype, each lane's
    bond embedding summed from its three table rows, the accumulation
    dtype)."""
    acc = _acc_dtype(h.dtype)
    nw = -(-h.shape[0] // window)
    vocab, d = ee_table.shape
    lanes = _ell_lanes(ell_meta, nw, window, vocab, acc)
    tab = torch.cat([ee_table.to(acc), torch.zeros(1, d, dtype=acc, device=h.device)])
    attrs = lanes[2]
    ee = tab[attrs[:, 0]] + tab[attrs[:, 1]] + tab[attrs[:, 2]]
    return lanes, _padded(h, nw * window).to(acc), ee, acc


def gin_local_layer_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, D] layer input
    m_spill: Optional[torch.Tensor],  # [n, D] spill tail's (and VN) messages, or None
    ee_table: torch.Tensor,  # [13, D] this layer's bond-embedding table
    w1: torch.Tensor,  # [H, D]
    b1: torch.Tensor,  # [H]
    w2: torch.Tensor,  # [D, H]
    b2: torch.Tensor,  # [D]
    eps1: torch.Tensor,  # [1, 1] 1+ε, float32 (float64 for f64 h)
    window: int,
    final_relu: bool,
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``gin_local_layer_ell``: the next h [n, D] in h's dtype.

    Per window row v over its lanes u → v, in lane order: acc = Σ rnd(relu(
    h_u + ee)), ee the sum of the lane's three table rows; act = rnd(acc +
    m_spill + (1+ε)·h), z = rnd(relu(act·w1ᵀ + b1)), out = z·w2ᵀ + b2, with
    a ReLU when ``final_relu`` (every layer but the last). A lane whose u
    lies outside [0, W) reads a zero source and one whose v does lands
    nowhere, as the TPU kernel's one-hot gather and scatter give. ``rnd``
    rounds to h's dtype; products and sums run in f32 (f64 for f64 inputs).
    ``m_spill=None`` adds nothing; ``mlp_tiles`` is not read."""
    cdt = h.dtype
    (gather, u_ok, _, accumulate), hf, ee, acc = _ell_layer_inputs(ell_meta, h, ee_table, window)
    agg = accumulate(_relu(hf[gather] * u_ok + ee).to(cdt).to(acc))
    return gin_epilogue(agg, hf, m_spill, w1, b1, w2, b2, eps1, final_relu, cdt)[: h.shape[0]]


def gin_epilogue(agg, hf, m_spill, w1, b1, w2, b2, eps1, final_relu, cdt) -> torch.Tensor:
    """The per-layer GIN kernels' epilogue over the padded rows: ``agg`` the
    f32 message sums, ``hf`` the layer input, both [NW·W, D] in the
    accumulation dtype; act = rnd(agg + m_spill + (1+ε)·h), z = rnd(relu(
    act·w1ᵀ + b1)), out = rnd(z·w2ᵀ + b2) with a ReLU when ``final_relu``."""
    acc = agg.dtype
    if m_spill is not None:
        agg = agg + _padded(m_spill.to(acc), hf.shape[0])
    act = (agg + eps1.reshape(()).to(acc) * hf).to(cdt).to(acc)
    z = _relu(act @ w1.to(acc).T + b1.to(acc)).to(cdt).to(acc)
    out = z @ w2.to(acc).T + b2.to(acc)
    if final_relu:
        out = _relu(out)
    return out.to(cdt)


def lane_rows(local: torch.Tensor, lane_window: torch.Tensor, window: int):
    """(each lane's row over the padded node axis, whether its in-window
    index lies in [0, W)) for in-window indices ``local`` [P] of lanes whose
    windows are ``lane_window`` [P]."""
    local = local.long()
    ok = (local >= 0) & (local < window)
    return lane_window * window + local.clamp(0, window - 1), ok


def _gin_lane_sums(ee, u_local, v_local, lane_window, h, window):
    """(per window row v over its lanes u → v in lane order, Σ rnd(relu(h_u
    + ee)) in the accumulation dtype [NW·W, D]; h padded to NW·W rows in it)
    for lanes that carry their bond embedding ``ee`` [P, D], their in-window
    endpoints and their window ``lane_window`` [P]. A lane whose u lies
    outside [0, W) reads a zero source and one whose v does lands nowhere."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    rows = -(-h.shape[0] // window) * window
    hf = _padded(h, rows).to(acc)
    gather, u_ok = lane_rows(u_local, lane_window, window)
    dest, v_ok = lane_rows(v_local, lane_window, window)
    msg = _relu(hf[gather] * u_ok[:, None].to(acc) + ee.to(acc)).to(cdt).to(acc)
    agg = torch.zeros(rows, h.shape[1], dtype=acc, device=h.device)
    return agg.index_add_(0, dest[v_ok], msg[v_ok]), hf


def _gin_layer_lanes(ee, u_local, v_local, lane_window, h, m_spill, w1, b1, w2, b2, eps1,
                     window, final_relu) -> torch.Tensor:
    """One GIN layer over lanes that carry their bond embedding (see
    ``_gin_lane_sums``): the message sums, then ``gin_epilogue``."""
    agg, hf = _gin_lane_sums(ee, u_local, v_local, lane_window, h, window)
    return gin_epilogue(agg, hf, m_spill, w1, b1, w2, b2, eps1, final_relu,
                        h.dtype)[: h.shape[0]]


def block_lane_windows(block_window: torch.Tensor, lanes: int) -> torch.Tensor:
    """Each lane's window, for ``lanes`` lanes in equal blocks whose windows
    are ``block_window`` [NB]."""
    return block_window.long().repeat_interleave(lanes // block_window.shape[0])


def gin_local_layer_ref(
    ee: torch.Tensor,  # [P, D] per-lane bond embeddings, P = NB·block
    u_local: torch.Tensor,  # [P] int in-window source (sentinel ``window`` on pads)
    v_local: torch.Tensor,  # [P] int in-window destination (sentinel on pads)
    block_window: torch.Tensor,  # [NB] int each block's window, non-decreasing
    h: torch.Tensor,  # [n, D] layer input
    m_spill: Optional[torch.Tensor],  # [n, D] spill tail's (and VN) messages, or None
    w1: torch.Tensor,  # [H, D]
    b1: torch.Tensor,  # [H]
    w2: torch.Tensor,  # [D, H]
    b2: torch.Tensor,  # [D]
    eps1: torch.Tensor,  # [1, 1] 1+ε, float32 (float64 for f64 h)
    window: int,
    final_relu: bool,
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``gin_local_layer``: one whole GIN / GIN-VN layer over the
    legacy dynamic-window local layout, the next h [n, D] in h's dtype. As
    ``gin_local_layer_ell_ref``, with each lane's bond embedding given (in
    h's dtype, where that kernel sums the table rows in f32) and each
    block's window named by ``block_window``."""
    lane_window = block_lane_windows(block_window, ee.shape[0])
    return _gin_layer_lanes(ee, u_local, v_local, lane_window, h, m_spill, w1, b1, w2, b2, eps1,
                            window, final_relu)


def gin_local_layer_ell_lanes_ref(
    ee: torch.Tensor,  # [NW·k·B, D] per-lane bond embeddings
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, three unused)
    h: torch.Tensor,  # [n, D] layer input
    m_spill: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps1: torch.Tensor,
    window: int,
    final_relu: bool,
    mlp_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``gin_local_layer_ell_lanes``: ``gin_local_layer_ell_ref``
    with each lane's bond embedding given in h's dtype instead of summed
    from the table (the JAX ``gin_local_layer_ell`` without ``edge_attr``).
    Every window owns the same number of lanes."""
    nw = -(-h.shape[0] // window)
    lane_window = block_lane_windows(torch.arange(nw, device=h.device), ee.shape[0])
    return _gin_layer_lanes(ee, ell_meta[:, 0], ell_meta[:, 1], lane_window, h, m_spill, w1, b1,
                            w2, b2, eps1, window, final_relu)


def gin_local_message_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    ee_table: torch.Tensor,  # [13, D] this layer's bond-embedding table
    h: torch.Tensor,  # [n, D] layer input
    window: int,
) -> torch.Tensor:
    """Plain-torch ``gin_local_message_ell``: m [n, D] in h's dtype, per
    window row v over its lanes u → v in lane order m[v] = rnd(Σ rnd(relu(
    h_u + ee))), ee the sum of the lane's three table rows. A lane whose u
    lies outside [0, W) reads a zero source and one whose v does lands
    nowhere. Sums run in f32 (f64 for f64 inputs)."""
    (gather, u_ok, _, accumulate), hf, ee, acc = _ell_layer_inputs(ell_meta, h, ee_table, window)
    agg = accumulate(_relu(hf[gather] * u_ok + ee).to(h.dtype).to(acc))
    return agg[: h.shape[0]].to(h.dtype)


def gin_local_message_ell_lanes_ref(
    ee: torch.Tensor,  # [NW·k·B, D] per-lane bond embeddings
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, three unused)
    h: torch.Tensor,  # [n, D] layer input
    m_spill: Optional[torch.Tensor],  # [n, D] messages added per row, or None
    window: int,
) -> torch.Tensor:
    """Plain-torch ``gin_local_message_ell_lanes``: m [n, D] in h's dtype,
    per window row v over its lanes u → v in lane order m[v] = rnd(Σ rnd(
    relu(h_u + ee)) + m_spill_v), each lane's bond embedding given in h's
    dtype (the JAX ``local_scatter_apply_ell`` with the ELL stage bench's
    pass-through epilogue). Every window owns the same number of lanes;
    ``m_spill=None`` adds nothing."""
    nw = -(-h.shape[0] // window)
    lane_window = block_lane_windows(torch.arange(nw, device=h.device), ee.shape[0])
    agg, hf = _gin_lane_sums(ee, ell_meta[:, 0], ell_meta[:, 1], lane_window, h, window)
    if m_spill is not None:
        agg = agg + _padded(m_spill.to(agg.dtype), hf.shape[0])
    return agg[: h.shape[0]].to(h.dtype)


def _gcn_ell_message(ell_meta, h, dis, ee_table, window):
    """(Σ rnd(dis_u·relu(h_u + ee)) per window row, h and dis_v padded to
    NW·W rows, the accumulation dtype) of rows 14 and 15. dis is rounded to
    h's dtype, as it rides the TPU kernels' gather."""
    (gather, u_ok, _, accumulate), hf, ee, acc = _ell_layer_inputs(ell_meta, h, ee_table, window)
    dis_v = _padded(dis.to(h.dtype).to(acc)[:, None], hf.shape[0])
    dis_u = dis_v[gather] * u_ok
    msg = (dis_u * _relu(hf[gather] + ee)).to(h.dtype).to(acc)
    return accumulate(msg), hf, dis_v, acc


def gcn_local_message_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, D] this layer's conv output
    dis: torch.Tensor,  # [n] 1/sqrt(out_deg + 1)
    ee_table: torch.Tensor,  # [13, D] this layer's bond-embedding table
    window: int,
) -> torch.Tensor:
    """Plain-torch ``gcn_local_message_ell``: m [n, D] in h's dtype, per
    window row v over its lanes u → v in lane order m[v] = rnd(dis_v · Σ
    rnd(dis_u·relu(h_u + ee))). A lane whose u lies outside [0, W) has
    dis_u = 0 and one whose v does lands nowhere. Products and sums run in
    f32 (f64 for f64 inputs)."""
    s, _, dis_v, _ = _gcn_ell_message(ell_meta, h, dis, ee_table, window)
    return (s * dis_v)[: h.shape[0]].to(h.dtype)


def gcn_local_layer_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, D] this layer's conv output
    dis: torch.Tensor,  # [n] 1/sqrt(out_deg + 1)
    ee_table: torch.Tensor,  # [13, D] this layer's bond-embedding table
    root: torch.Tensor,  # [D] root embedding
    alpha: torch.Tensor,  # [D] folded-BN scale
    beta: torch.Tensor,  # [D] folded-BN shift
    w_next: Optional[torch.Tensor],  # [D, D] next conv weight as [in, out], None on the last layer
    b_next: Optional[torch.Tensor],  # [D] next conv bias, None on the last layer
    window: int,
    conv_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``gcn_local_layer_ell``: [n, D] in h's dtype. Per window
    row v: a = dis_v·Σ rnd(dis_u·relu(h_u + ee)) + relu(h_v + root)·dis_v²
    (the TPU kernel's dis², where the plain path divides by deg + 1), x =
    alpha·a + beta; the last layer (``w_next`` None) returns rnd(x), every
    other rnd(rnd(relu(x))·w_next + b_next), the next conv's output.
    Products and sums run in f32 (f64 for f64 inputs)."""
    s, hf, dis_v, acc = _gcn_ell_message(ell_meta, h, dis, ee_table, window)
    a = s * dis_v + _relu(hf + root.to(acc)) * (dis_v * dis_v)
    x = alpha.to(acc) * a + beta.to(acc)
    if w_next is not None:
        x = _relu(x).to(h.dtype).to(acc) @ w_next.to(acc) + b_next.to(acc)
    return x[: h.shape[0]].to(h.dtype)


def _dgn_ell_channels(ell_meta, h, eig, window):
    """(m1, m2, h padded to NW·W rows, the accumulation dtype) of rows 16
    and 18: per window row v over its lanes u → v in lane order, acc =
    Σ rnd([h_u ‖ eig_u·h_u]) in f32, eig rounded to h's dtype (it rides the
    TPU kernels' gather); m1 = acc₁ and m2 = acc₂ − eig_v·m1, the TPU
    kernels' factoring of Σ (eig_u − eig_v)·h_u. A lane whose u lies outside
    [0, W) reads a zero source and one whose v does lands nowhere."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    d = h.shape[1]
    rows = -(-h.shape[0] // window) * window
    gather, u_ok, _, accumulate = _ell_lanes(ell_meta, rows // window, window, 0, acc)
    hf = _padded(h, rows).to(acc)
    e_v = _padded(eig.to(cdt).to(acc)[:, None], rows)
    x = hf[gather] * u_ok
    s = accumulate(torch.cat([x, e_v[gather] * x], dim=1).to(cdt).to(acc))
    m1 = s[:, :d]
    return m1, s[:, d:] - e_v * m1, hf, acc


def dgn_local_message_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, D]
    eig: torch.Tensor,  # [n] Fiedler-vector entry
    window: int,
) -> torch.Tensor:
    """Plain-torch ``dgn_local_message_ell``: [n, 2D] [m1 ‖ m2] in h's
    dtype, m1 = Σ h_u and m2 = Σ (eig_u − eig_v)·h_u over each row's lanes,
    factored and rounded as ``_dgn_ell_channels`` says (the JAX kernel
    returns the two halves as a pair). Sums run in f32 (f64 for f64
    inputs)."""
    m1, m2, _, _ = _dgn_ell_channels(ell_meta, h, eig, window)
    return torch.cat([m1, m2], dim=1)[: h.shape[0]].to(h.dtype)


def dgn_local_layer_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, D]
    eig: torch.Tensor,  # [n] Fiedler-vector entry
    inv_deg: torch.Tensor,  # [n] 1/max(out_deg, 1)
    eigw_sum: torch.Tensor,  # [n] Σ over in-edges of eig_u − eig_v
    inv_abssum: torch.Tensor,  # [n] 1/Σ|eig_u − eig_v| (zero → 1/EIG_EPS)
    w_post: torch.Tensor,  # [2D, D] posttrans, right-multiplied
    b_post: torch.Tensor,  # [1, D]
    window: int,
    posttrans_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``dgn_local_layer_ell``: one whole DGN layer over the
    ELL layout with no spill tail, the next h [n, D] in h's dtype. The
    channels as in ``dgn_local_message_ell_ref``; the four node terms are
    rounded to h's dtype (they ride the TPU kernel's feature tile); a =
    rnd([m1·invd ‖ |m2 − ews·h|·inva]), y = a·w_post + b_post and h' =
    rnd(h + relu(y)). Products and sums run in f32 (f64 for f64 inputs)."""
    cdt = h.dtype
    m1, m2, hf, acc = _dgn_ell_channels(ell_meta, h, eig, window)
    invd, ews, inva = (
        _padded(v.to(cdt).to(acc)[:, None], hf.shape[0]) for v in (inv_deg, eigw_sum, inv_abssum)
    )
    a = torch.cat([m1 * invd, (m2 - ews * hf).abs() * inva], dim=1).to(cdt).to(acc)
    y = a @ w_post.to(acc) + b_post.to(acc)
    return (hf + _relu(y)).to(cdt)[: h.shape[0]]


def gat_local_message_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, H·D] projected features, head-major
    s_src: torch.Tensor,  # [n, H] destination scores
    s_tgt: torch.Tensor,  # [n, H] source scores
    window: int,
    num_heads: int,
) -> torch.Tensor:
    """Plain-torch ``gat_local_message_ell``: [n, H·D + H] [Σ score·h_u ‖
    Σ score] in h's dtype, per window row v and head k over its lanes u → v
    in lane order, score = exp(leaky(s_src[v] + s_tgt[u], 0.2)) in f32 with
    s_tgt rounded to h's dtype (it rides h's gather). Each lane's [score·h_u
    ‖ score] is rounded to h's dtype before the f32 sum; the caller adds the
    spill tail and divides. A lane whose u lies outside [0, W) reads a zero
    source and zero score term; a lane whose v does (a sentinel lane) adds
    nothing, whatever its score: it is skipped, where the TPU kernel
    multiplies its exp by the lane's validity. Sums run in f32 (f64 for f64
    inputs)."""
    return _gat_ell_sums(ell_meta, h, s_src, s_tgt, window, num_heads)[: h.shape[0]].to(h.dtype)


def _gat_ell_sums(ell_meta, h, s_src, s_tgt, window, num_heads) -> torch.Tensor:
    """The f32 sums [NW·W, H·D + H] of rows 17 and 23, before any rounding
    of the sums themselves (see ``gat_local_message_ell_ref``)."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    n, hd = h.shape
    nw = -(-n // window)
    rows = nw * window
    gather, u_ok, _, accumulate = _ell_lanes(ell_meta, nw, window, 0, acc)
    v = ell_meta.long().reshape(nw, -1, 5)[..., 1].clamp(0, window - 1)
    dest = (torch.arange(nw, device=h.device)[:, None] * window + v).reshape(-1)
    hf = _padded(h, rows).to(acc)
    st = _padded(s_tgt.to(cdt), rows).to(acc)
    ss = _padded(s_src, rows).to(acc)
    raw = ss[dest] + st[gather] * u_ok
    score = torch.exp(torch.where(raw < 0, raw * 0.2, raw))
    both = torch.cat([score.repeat_interleave(hd // num_heads, dim=1) * hf[gather] * u_ok, score],
                     dim=1)
    return accumulate(both.to(cdt).to(acc))


def gat_local_layer_ell_ref(
    ell_meta: torch.Tensor,  # [NW·k·B, 5] int (u_local, v_local, attrs+offsets)
    h: torch.Tensor,  # [n, H·D] projected features, head-major
    s_src: torch.Tensor,  # [n, H] destination scores
    s_tgt: torch.Tensor,  # [n, H] source scores
    prev: torch.Tensor,  # [n, H·D] the previous layer's features (skip input)
    spill_both: Optional[torch.Tensor],  # [n, H·D + H] spill tail's sums, or None
    w_skip: torch.Tensor,  # [H·D, H·D] this layer's skip projection, [out, in]
    w_proj: torch.Tensor,  # [H·D, H·D] the next layer's projection, [out, in]
    a_mat: torch.Tensor,  # [H·D, 2H] block-diagonal (a_src ‖ a_tgt) of the next layer
    window: int,
    num_heads: int,
    layer_tiles: Optional[torch.Tensor] = None,  # the kernel's packed weights; not read here
) -> torch.Tensor:
    """Plain-torch ``gat_local_layer_ell``: one whole non-final GAT layer
    over the ELL layout, [n, 2·H·D + 2H] = (h_next ‖ feat ‖ s_src' ‖ s_tgt')
    in h's dtype. The sums as in ``gat_local_message_ell_ref`` (each lane's
    [score·h_u ‖ score] rounded to h's dtype before the f32 sum), then all
    in f32 with no rounding in between: tot = sums + spill_both, msg =
    tot[:H·D] / den with a zero den taken as 1, x = msg + prev·w_skipᵀ, feat
    = ELU(x) = x where x > 0 else exp(min(x, 0)) − 1, h_next = feat·w_projᵀ,
    scores = h_next·a_mat; the output is rounded once. The unfused path
    rounds at each of these steps, so the two agree to rounding only."""
    cdt = h.dtype
    acc = _acc_dtype(cdt)
    n, hd = h.shape
    tot = _gat_ell_sums(ell_meta, h, s_src, s_tgt, window, num_heads)
    if spill_both is not None:
        tot = tot + _padded(spill_both.to(acc), tot.shape[0])
    den = tot[:, hd:]
    den = torch.where(den == 0, 1.0, den).repeat_interleave(hd // num_heads, dim=1)
    x = tot[:, :hd] / den + _padded(prev, tot.shape[0]).to(acc) @ w_skip.to(acc).T
    feat = torch.where(x > 0, x, torch.exp(torch.clamp_max(x, 0.0)) - 1.0)
    h_next = feat @ w_proj.to(acc).T
    return torch.cat([h_next, feat, h_next @ a_mat.to(acc)], dim=1)[:n].to(cdt)


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
    ``_max_d`` and ``_max_slots``, a whole-model ELL library ``_max_d``,
    ``_rows_per_block`` and ``_max_cluster``, a per-layer ELL library
    ``_max_d``, ``_rows_per_block`` and ``_max_window_blocks`` (GAT's also
    ``_max_heads``), as do the legacy local and fused edge-block layers and
    GAT's per-layer slot library (row 21; also ``_max_slots``). The
    GIN and PNA slot libraries also export ``_rows_per_block`` and
    ``_max_cluster``, as do the GCN, DGN and GAT slot libraries and the
    per-layer PNA and DGN slot libraries (rows 20 and 22); the libraries
    of ``GIN_MLP_LIBRARIES`` ``_mlp_dims``, the per-layer GIN libraries
    (``GIN_LAYER_LIBRARIES``: rows 13, 10 / 12 and 25) and row 23
    ``_smem_per_sm``, ``_prepare`` and ``_occupancy`` (row 23 also
    ``_tile_dims``), and the users of ``csrc/linear_wgmma.cuh`` the geometry
    of their weight chunks (rows 9, 2 and 15 ``_conv_dims``, rows 3 and 20
    ``_tower_dims``, rows 4, 22 and 18 ``_posttrans_dims``, row 5
    ``_glue_dims``), those that keep two
    blocks an SM (rows 9, 2, 15, 4, 5, 22 and 18) and row 20 also
    ``_smem_per_sm`` and ``_occupancy``, rows 14, 16 and 19 (the
    messages-, channels- and stats-only forms; row 19's slot library also
    ``_rows_per_block`` and ``_max_cluster``) ``_occupancy``; row 24
    (``windowed_segment_sum``) ``_chunk``, its list's lanes."""
    slot_getters = ("max_d", "max_slots")
    ell_getters = ("max_d", "rows_per_block", "max_cluster")
    layer_getters = ("max_d", "rows_per_block", "max_window_blocks")
    prefix, getters, smem_args, launch_args = {
        "gin_local_model_slots": (
            "gin_slots", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 7,
            [_I32] + [_PTR] * 13 + [_I32] * 10 + [_INT_P] + [_I32] * 4 + [_PTR],
        ),
        "gcn_local_model_slots": (
            "gcn_slots", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 6,
            [_I32] + [_PTR] * 13 + [_I32] * 9 + [_INT_P] + [_I32] * 4 + [_PTR],
        ),
        "pna_local_model": (
            "pna_model", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 5,
            [_I32] + [_PTR] * 11 + [_I32] * 7 + [_F32, _F32, _INT_P] + [_I32] * 4 + [_PTR],
        ),
        "dgn_local_model": (
            "dgn_model", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 5,
            [_I32] + [_PTR] * 12 + [_I32] * 7 + [_INT_P] + [_I32] * 4 + [_PTR],
        ),
        "gat_local_model_slots": (
            "gat_slots", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 6,
            [_I32] + [_PTR] * 10 + [_I32] * 8 + [_INT_P] + [_I32] * 4 + [_PTR],
        ),
        "gin_local_model": (
            "gin_ell", ell_getters, [_I32] * 7,
            [_I32] + [_PTR] * 13 + [_I32] * 12 + [_I32, _PTR],
        ),
        "gcn_local_model": (
            "gcn_ell", ell_getters, [_I32] * 6,
            [_I32] + [_PTR] * 13 + [_I32] * 11 + [_I32, _PTR],
        ),
        "pna_local_stats_slots": (
            "pna_stats", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 3,
            [_I32] + [_PTR] * 3 + [_I32] * 5 + [_F32, _F32, _I32, _I32, _PTR],
        ),
        "dgn_local_layer_slots": (
            "dgn_layer", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 3,
            [_I32] + [_PTR] * 11 + [_I32] * 8 + [_PTR],
        ),
        "gat_local_message_slots": (
            "gat_msg", layer_getters + ("max_slots", "max_heads"), [_I32] * 2,
            [_I32] + [_PTR] * 5 + [_I32] * 8 + [_I32, _PTR],
        ),
        "windowed_segment_sum": (
            "wss", ("chunk",), [],
            [_I32] + [_PTR] * 4 + [_I32] * 8 + [_I32, _PTR],
        ),
        "gin_local_layer_ell": (
            "gin_layer_ell", layer_getters, [_I32] * 5,
            [_I32] + [_PTR] * 11 + [_I32] * 10 + [_I32, _PTR],
        ),
        "gcn_local_message_ell": (
            "gcn_msg_ell", layer_getters, [_I32] * 3,
            [_I32] + [_PTR] * 5 + [_I32] * 7 + [_I32, _PTR],
        ),
        "gcn_local_layer_ell": (
            "gcn_layer_ell", layer_getters, [_I32] * 4,
            [_I32] + [_PTR] * 11 + [_I32] * 8 + [_I32, _PTR],
        ),
        "pna_local_layer_slots": (
            "pna_layer", slot_getters + ("rows_per_block", "max_cluster"), [_I32] * 3,
            [_I32] + [_PTR] * 9 + [_I32] * 5 + [_F32, _F32] + [_I32] * 3 + [_PTR],
        ),
        "dgn_local_layer_ell": (
            "dgn_msg_ell", layer_getters, [_I32] * 2,
            [_I32] + [_PTR] * 4 + [_I32] * 6 + [_I32, _PTR],
        ),
        "dgn_local_layer_ell_model": (
            "dgn_layer_ell", layer_getters, [_I32] * 3,
            [_I32] + [_PTR] * 10 + [_I32] * 7 + [_I32, _PTR],
        ),
        "gat_local_message_ell": (
            "gat_msg_ell", layer_getters + ("max_heads",), [_I32] * 2,
            [_I32] + [_PTR] * 5 + [_I32] * 7 + [_I32, _PTR],
        ),
        # One kernel behind two wrappers: the legacy local layer and the ELL
        # layer with per-lane bond embeddings.
        "gin_local_layer_blocks": (
            "gin_layer_blocks", layer_getters, [_I32] * 4,
            [_I32] + [_PTR] * 13 + [_I32] * 11 + [_I32, _PTR],
        ),
        "gin_layer_fused": (
            "gin_fused", layer_getters, [_I32] * 4,
            [_I32] + [_PTR] * 11 + [_I32] * 10 + [_I32, _PTR],
        ),
        "gat_local_layer_ell": (
            "gat_layer_ell", layer_getters + ("max_heads",), [_I32] * 4,
            [_I32] + [_PTR] * 9 + [_I32] * 8 + [_I32, _PTR],
        ),
        # The messages-only forms of rows 13 and 12 (row 31 and row 12's
        # pass-through).
        "gin_local_message_ell": (
            "gin_msg_ell", layer_getters, [_I32] * 3,
            [_I32] + [_PTR] * 4 + [_I32] * 6 + [_I32, _PTR],
        ),
        "gin_local_message_lanes": (
            "gin_msg_lanes", layer_getters, [_I32] * 2,
            [_I32] + [_PTR] * 6 + [_I32] * 6 + [_I32, _PTR],
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
    if name in GIN_MLP_LIBRARIES:  # the bf16 form's weight chunks
        f = getattr(lib, f"{prefix}_mlp_dims")
        f.argtypes, f.restype = [_I32, _I32, _INT_P], None
        fns["mlp_dims"] = f
    per_sm = ("smem_per_sm", [_I32], _I64)  # the ring's depth keeps two blocks an SM
    # The per-layer kernels whose launch plan is cached (_gin_layer_plan,
    # _gat_layer_plan).
    prepare = ("prepare", [_I64, _I32], _I32)
    gin_occupancy = ("occupancy", [_I32, _I32, _I32, _I64, _INT_P], _I32)
    extras = {
        **{k: (per_sm, prepare, gin_occupancy) for k in GIN_LAYER_LIBRARIES},
        "gat_local_layer_ell": (per_sm, prepare, ("tile_dims", [_I32, _INT_P], None),
                                ("occupancy", [_I32, _I32, _I64, _INT_P], _I32)),
        "gcn_local_model": (per_sm, ("conv_dims", [_I32, _INT_P], None),
                            ("occupancy", [_I32] * 8 + [_INT_P], _I32)),
        "gcn_local_model_slots": (per_sm, ("conv_dims", [_I32, _INT_P], None),
                                  ("occupancy", [_I32] * 8 + [_INT_P], _I32)),
        "pna_local_model": (("tower_dims", [_I32, _INT_P], None),),
        "dgn_local_model": (per_sm, ("posttrans_dims", [_I32, _INT_P], None),
                            ("occupancy", [_I32] * 7 + [_INT_P], _I32)),
        "pna_local_layer_slots": (per_sm, ("tower_dims", [_I32, _INT_P], None),
                                  ("occupancy", [_I32] * 5 + [_INT_P], _I32)),
        "dgn_local_layer_slots": (per_sm, ("posttrans_dims", [_I32, _INT_P], None),
                                  ("occupancy", [_I32] * 5 + [_INT_P], _I32)),
        "dgn_local_layer_ell_model": (per_sm, ("posttrans_dims", [_I32, _INT_P], None),
                                      ("occupancy", [_I32] * 5 + [_INT_P], _I32)),
        "gcn_local_layer_ell": (per_sm, ("conv_dims", [_I32, _INT_P], None),
                                ("occupancy", [_I32] * 6 + [_INT_P], _I32)),
        "gcn_local_message_ell": (("occupancy", [_I32] * 5 + [_INT_P], _I32),),
        "dgn_local_layer_ell": (("occupancy", [_I32] * 4 + [_INT_P], _I32),),
        "pna_local_stats_slots": (("occupancy", [_I32] * 5 + [_INT_P], _I32),),
        **{k: (("occupancy", [_I32, _I64, _INT_P], _I32),) for k in GIN_MESSAGE_LIBRARIES},
        "gat_local_model_slots": (per_sm, ("glue_dims", [_I32, _INT_P], None),
                                  ("occupancy", [_I32] * 8 + [_INT_P], _I32)),
    }
    for suffix, args, res in extras.get(name, ()):
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
    """Raise before launch on a window an ELL kernel cannot span (whole
    blocks of ``rows_per_block`` rows, at most ``max_cluster`` or
    ``max_window_blocks`` of them) or what its tile or the card's shared
    memory cannot take."""
    rows = lib["rows_per_block"]()
    most = lib["max_cluster" if "max_cluster" in lib else "max_window_blocks"]()
    if window % rows or not 1 <= window // rows <= most:
        raise ValueError(
            f"window {window} is not 1..{most} whole blocks of {rows} rows"
        )
    _check_smem(lib, d, window, smem, dev)


def _check_tile(lib, d: int) -> None:
    if "max_d" in lib and d > lib["max_d"]():
        raise ValueError(f"D={d} exceeds the kernel's tile ({lib['max_d']()})")


def _check_smem(lib, d: int, window: int, smem: int, dev) -> None:
    _check_tile(lib, d)
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
                vn_col, tiles, knockout=0) -> torch.Tensor:
    dev = h0.device
    nw = -(-h0.shape[0] // window)
    caps, _, sw = _slot_prefix_geom(prefix_caps, window, slots)
    _check("slot_meta", slot_meta, torch.int32, (nw * sw, 4), dev)
    return _launch_gin_model(gin_local_model_slots, _library("gin_local_model_slots"), slot_meta,
                             _center(window), h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                             b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col, tiles,
                             slot_geom=(caps, slots), knockout=knockout)


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
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """GIN whole-model slot megakernel: [NW·GMAX, T] f32 per-window pool
    sums (``base.pool_finish`` divides by node counts and adds the bias),
    at windows of 128 up to 1024 rows (one thread-block cluster of W/128
    blocks per window).

    Operands as in ``gin_local_model_slots_ref``. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel, which takes float32
    or bfloat16 activations and weights with int32 ``slot_meta`` /
    ``pool_gl`` and float32 ``eps_all``, or raises. In bfloat16 its update
    MLP runs on the tensor cores from ``mlp_tiles``, the weight chunks as
    ``mlp_tiles()`` packs them (packed here, once per weight set, when not
    given); ``gin_local_model_slots.stages`` records the launch's weight
    ring (0 in float32). ``knockout`` (timing only): the ``GIN_KNOCKOUTS``
    bits, which the plain version computes too; 0 launches the production
    kernel, any other value the kernel that reads them. Each launch adds one
    to ``gin_local_model_slots.launches``."""
    args = (slot_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
            eps_all, pred_w, window, slots, num_layers, gmax, prefix_caps, vn_col, mlp_tiles,
            knockout)
    return _dispatch(h0, gin_local_model_slots_ref, _launch_gin, args)


gin_local_model_slots.launches = 0
gin_local_model_slots.stages = 0


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
                prefix_caps, tiles, knockout=0) -> torch.Tensor:
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
    tiles, stages, smem = _gcn_conv_operand(lib, code, d, vocab, gmax, t_out, L, wn_all, tiles, dev)
    _check_ell_geometry(lib, d, window, smem, dev)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_meta.data_ptr(), h0.data_ptr(), dis.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), roots.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), wn_all.data_ptr(), bn_all.data_ptr(),
        pred_w.data_ptr(), None if code == 0 else tiles.data_ptr(), out.data_ptr(),
        nw, n, window, _center(window), d, L, vocab, gmax, t_out,
        caps_arr, slots, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gcn_local_model_slots")
    gcn_local_model_slots.launches += 1
    gcn_local_model_slots.stages = stages
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
    conv_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """GCN whole-model slot megakernel (after conv 0): [NW·GMAX, T] f32
    per-window pool sums, at windows of 128 up to 1024 rows (one
    thread-block cluster of W/128 blocks per window; ``gcn_local_model``'s
    kernel with the slot message stage). Operands as in
    ``gcn_local_model_slots_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 activations, norms
    and weights, int32 ``slot_meta`` / ``pool_gl``; D even, at most 112) or
    raises. In bfloat16 the next conv runs on the tensor cores (``wgmma``)
    from ``conv_tiles`` as ``gcn_conv_tiles`` packs them (packed here, once
    per weight set, when not given); ``gcn_local_model_slots.stages``
    records the launch's weight ring (0 in float32). ``knockout`` (timing
    only, CUDA only): bit 0 skips the next conv, bit 1 the messages. Each
    launch adds one to ``gcn_local_model_slots.launches``."""
    args = (slot_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
            wn_all, bn_all, pred_w, window, slots, num_layers, gmax, prefix_caps, conv_tiles)
    if _knocked_out(h0, knockout):
        return _launch_gcn(*args, knockout=knockout)
    return _dispatch(h0, gcn_local_model_slots_ref, _launch_gcn, args)


gcn_local_model_slots.launches = 0
gcn_local_model_slots.stages = 0


def _ell_block(ell_meta: torch.Tensor, nw: int, dev) -> int:
    """Checks ``ell_meta``; returns its lanes per window (k·B; k=1: one
    block)."""
    lanes = ell_meta.shape[0]
    if lanes % nw:
        raise ValueError(f"ell_meta: {lanes} lanes are not {nw} equal window blocks")
    _check("ell_meta", ell_meta, torch.int32, (lanes, 5), dev)
    return lanes // nw


# The libraries of the per-layer GIN kernels (``csrc/gin_layer.cuh``'s one
# body: rows 13, 10 / 12 and 25), and of every GIN kernel whose bf16 update
# MLP is ``csrc/gin_mlp.cuh``'s: those and rows 1 and 8.
GIN_LAYER_LIBRARIES = ("gin_local_layer_ell", "gin_local_layer_blocks", "gin_layer_fused")
GIN_MLP_LIBRARIES = ("gin_local_model_slots", "gin_local_model", *GIN_LAYER_LIBRARIES)
MLP_CHUNK = 32  # hidden units per weight chunk of the bf16 MLP


def gin_mlp_geometry(d: int, hid: int) -> tuple[int, int, int, int, int]:
    """The bf16 MLP's tile geometry (``csrc/gin_mlp.cuh``: ``geom``) at width
    ``d`` and hidden width ``hid``: (D' = d padded to 16, H' = hid padded to
    whole chunks of 32, N2 = the second product's width, 104 or 112, the
    chunks per layer H'/32, the bf16 elements of one chunk (D' + N2)·32)."""
    dp = -(-d // 16) * 16
    hp = -(-hid // MLP_CHUNK) * MLP_CHUNK
    n2 = 104 if d <= 104 else 112
    return dp, hp, n2, hp // MLP_CHUNK, (dp + n2) * MLP_CHUNK


def gin_mlp_tiles(w1_all: torch.Tensor, w2_all: torch.Tensor, num_layers: int) -> torch.Tensor:
    """The bf16 MLP's weight chunks of every layer, [L, C, (D' + N2)·32] in
    ``w1_all``'s dtype: chunk c of layer l is W1's rows 32c..32c+31 [32, D]
    as the wgmma B operand [D'/8, 32, 8], then W2's columns 32c..32c+31
    [D, 32] as [4, N2, 8] (``ops.tiles.kmajor_tiles``; pads zero), so that
    one bulk copy brings a chunk into shared memory as the kernel reads it.
    ``w1_all`` [L·H, D], ``w2_all`` [L·D, H] as the kernels take them."""
    L = num_layers
    hid, d = w1_all.shape[0] // L, w1_all.shape[1]
    dp, hp, n2, chunks, _ = gin_mlp_geometry(d, hid)
    w1 = w1_all.new_zeros(L, hp, dp)
    w1[:, :hid, :d] = w1_all.view(L, hid, d)
    w2 = w2_all.new_zeros(L, n2, hp)
    w2[:, :d, :hid] = w2_all.view(L, d, hid)
    t1 = kmajor_tiles(w1.view(L, chunks, MLP_CHUNK, dp), MLP_CHUNK, dp)
    t2 = kmajor_tiles(w2.view(L, n2, chunks, MLP_CHUNK).transpose(1, 2), n2, MLP_CHUNK)
    return torch.cat([t1.reshape(L, chunks, -1), t2.reshape(L, chunks, -1)], dim=2).contiguous()


# Packed weight chunks by weight set, newest last: (tiles, *the source
# weights). Holding the weights keeps their storage, and so the key, from
# being reused.
_MLP_TILES: collections.OrderedDict = collections.OrderedDict()
MLP_TILE_SETS = 8  # weight sets kept
_HELD: list = []  # the lists ``hold_packs`` collects into, innermost last


@contextlib.contextmanager
def hold_packs(into: list):
    """Inside the block, every tensor ``_pack_once`` hands out is appended
    to ``into`` too. A CUDA graph captured in the block reads its weight
    chunks at fixed addresses; whoever keeps the graph keeps ``into``, so
    that the cache's eviction of an older weight set cannot free chunks the
    graph still reads (``runtime.stream``)."""
    _HELD.append(into)
    try:
        yield into
    finally:
        _HELD.remove(into)


def _weight_key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), tuple(t.stride()),
            t.dtype, str(t.device), t._version)


def _pack_once(kind: tuple, sources: tuple, pack) -> torch.Tensor:
    """``pack()`` of a weight set, packed once: later calls of the same
    ``kind`` with the same ``sources`` (the same storage, offset, shape,
    strides, dtype and device, and the same version, so a weight changed in
    place is repacked) return the same tensor. Inference tensors, which keep
    no version, are packed on every call."""
    if any(t.is_inference() for t in sources):
        tiles = pack()
    else:
        key = kind + tuple(_weight_key(t) for t in sources)
        hit = _MLP_TILES.get(key)
        if hit is not None:
            _MLP_TILES.move_to_end(key)
            tiles = hit[0]
        else:
            tiles = pack()
            _MLP_TILES[key] = (tiles, *sources)
            while len(_MLP_TILES) > MLP_TILE_SETS:
                _MLP_TILES.popitem(last=False)
    for into in _HELD:
        into.append(tiles)
    return tiles


def mlp_tiles(w1_all: torch.Tensor, w2_all: torch.Tensor, num_layers: int) -> torch.Tensor:
    """``gin_mlp_tiles`` of a weight set, packed once (``_pack_once``)."""
    return _pack_once(("gin_mlp", num_layers), (w1_all, w2_all),
                      lambda: gin_mlp_tiles(w1_all, w2_all, num_layers))


# The bf16 product of rows 9 and 3 (``csrc/linear_wgmma.cuh``): B streamed
# in chunks of 32 input channels.
LINEAR_CHUNK = 32
PNA_PITCH = 80  # row 3's bf16 tower: scaler p's outputs at columns 80p + c
GAT_PITCH = 64  # row 5's bf16 glue: proj's outputs at columns c, skip's at 64 + c


def linear_geometry(k: int, n: int) -> tuple[int, int, int]:
    """The bf16 product's weight chunks (``csrc/linear_wgmma.cuh``: ``geom``)
    for K = ``k`` input channels and width ``n``: (K' = k padded to whole
    chunks of 32, the chunks, the bf16 elements of one chunk 32·n)."""
    kp = -(-k // LINEAR_CHUNK) * LINEAR_CHUNK
    return kp, kp // LINEAR_CHUNK, LINEAR_CHUNK * n


def linear_tiles(wt: torch.Tensor, n: int) -> torch.Tensor:
    """The weight chunks of a stack of products, [L, C, 32·n] in ``wt``'s
    dtype: ``wt`` [L, N, K] holds each layer's Bᵀ (B [K, N], the product
    x·B), N ≤ ``n``; chunk c of layer l is B's rows 32c..32c+31 as the wgmma
    B operand [4, n, 8] (``ops.tiles.kmajor_tiles``; pads zero), so that one
    bulk copy brings a chunk into shared memory as the kernel reads it."""
    L, _, k = wt.shape
    kp, chunks, elems = linear_geometry(k, n)
    return kmajor_tiles(wt, n, kp).reshape(L, chunks, elems)


def gcn_conv_n(d: int) -> int:
    """Row 9's bf16 next-conv width at width ``d`` (``conv_n``)."""
    return 104 if d <= 104 else 112


def gcn_conv_tiles(wt: torch.Tensor) -> torch.Tensor:
    """Row 9's next-conv weight chunks, packed once per weight set: ``wt``
    [L−1, D, D] holds each next conv's weight as [out, in] (the model's
    ``conv_w[1:]``; ``wn_all``'s blocks transposed)."""
    return _pack_once(("gcn_conv",), (wt,), lambda: linear_tiles(wt, gcn_conv_n(wt.shape[1])))


def pna_tower_tiles(w3: torch.Tensor) -> torch.Tensor:
    """Row 3's tower weight chunks, packed once per weight set: ``w3`` [L, 3,
    D, 4D] holds each layer's tower as [scaler, out, in] (the model's
    ``conv_w`` with its scaler axis first); scaler p's D outputs become
    columns 80p..80p+D−1 of the product's 240 (pads zero)."""
    def pack():
        L, p, d, k = w3.shape
        wt = w3.new_zeros(L, p, PNA_PITCH, k)
        wt[:, :, :d] = w3
        return linear_tiles(wt.reshape(L, p * PNA_PITCH, k), p * PNA_PITCH)

    return _pack_once(("pna_tower",), (w3,), pack)


def dgn_posttrans_tiles(wt: torch.Tensor) -> torch.Tensor:
    """Row 4's posttrans weight chunks, packed once per weight set: ``wt``
    [L, D, 2D] holds each layer's posttrans as [out, in] (the model's
    ``posttrans_w``; ``w_all``'s blocks transposed); the product's width is
    row 9's rule (``gcn_conv_n``), the pads zero."""
    return _pack_once(("dgn_posttrans",), (wt,), lambda: linear_tiles(wt, gcn_conv_n(wt.shape[1])))


def pna_layer_tiles(w_cat: torch.Tensor) -> torch.Tensor:
    """Row 20's tower chunks of one layer, [C, 32·240], packed once per
    weight set: ``pna_tower_tiles`` of the layer's ``w_cat`` [4D, 3D] (= [in,
    scaler·out]) as a one-layer stack. The models hand over their slice of
    every layer's chunks instead (``pna.tower_tiles``)."""
    d = w_cat.shape[1] // 3
    return pna_tower_tiles(w_cat.view(1, 4 * d, 3, d).permute(0, 2, 3, 1))[0]


def gcn_layer_tiles(w_next: torch.Tensor) -> torch.Tensor:
    """Row 15's next-conv chunks of one layer, [C, 32·N], packed once per
    weight set: ``gcn_conv_tiles`` of the layer's right-multiplied ``w_next``
    [D, D] (= [in, out]) as a one-layer stack. The model hands over its
    slice of every layer's chunks instead (``gcn.conv_tiles``)."""
    d = w_next.shape[0]
    return gcn_conv_tiles(w_next.view(1, d, d).transpose(1, 2))[0]


def dgn_layer_tiles(w_post: torch.Tensor) -> torch.Tensor:
    """Row 22's posttrans chunks of one layer, [C, 32·N], packed once per
    weight set: ``dgn_posttrans_tiles`` of the layer's right-multiplied
    ``w_post`` [2D, D] as a one-layer stack. The models hand over their
    slice of every layer's chunks instead (``dgn.posttrans_tiles``)."""
    d = w_post.shape[1]
    return dgn_posttrans_tiles(w_post.view(1, 2 * d, d).transpose(1, 2))[0]


def gat_glue_tiles(proj_t: torch.Tensor, skip_t: torch.Tensor) -> torch.Tensor:
    """Row 5's glue weight chunks, packed once per weight set: ``proj_t`` and
    ``skip_t`` [L−1, H·D, H·D] hold layers 1..L−1's projection and skip
    weights as [out, in] (the model's ``proj_w[1:]`` and ``skip_w[1:]``);
    one product feat·[proj ‖ skip] 128 wide, proj's H·D outputs at columns
    0.., skip's at 64.. (pads zero)."""
    def pack():
        layers, hd, _ = proj_t.shape
        wt = proj_t.new_zeros(layers, 2 * GAT_PITCH, hd)
        wt[:, :hd] = proj_t
        wt[:, GAT_PITCH : GAT_PITCH + hd] = skip_t
        return linear_tiles(wt, 2 * GAT_PITCH)

    return _pack_once(("gat_glue",), (proj_t, skip_t), pack)


GAT_LAYER_N = 64  # row 23's products' width: the widest H·D


def gat_layer_geometry(hd: int) -> tuple[int, int, int, int]:
    """Row 23's bf16 weight chunks at H·D = ``hd`` (``csrc/gat_local_layer_ell.cu``:
    ``geom``): (K' = hd padded to whole chunks of 32, the skip product's
    chunks K'/32, the projection's 2K'/32, the bf16 elements of one chunk
    32·64)."""
    kp, chunks, elems = linear_geometry(hd, GAT_LAYER_N)
    return kp, chunks, 2 * chunks, elems


def gat_layer_pack(w_skip: torch.Tensor, w_proj: torch.Tensor) -> torch.Tensor:
    """Row 23's weights of a stack of layers as its kernel reads them:
    ``w_skip`` and ``w_proj`` [L', H·D, H·D] as [out, in], each layer's skip
    weight and the next layer's projection. bfloat16: [L', C, 32·64], the
    skip product's K'/32 chunks of w_skipᵀ [K', 64], then the projection's
    2K'/32 chunks of [w_projᵀ; w_projᵀ] [2K', 64] (the hi and the lo half
    of feat meet the same weights; ``linear_tiles``); float32: [L', 2, H·D,
    64], w_skipᵀ then w_projᵀ. Pads zero."""
    layers, hd, _ = w_skip.shape
    if w_skip.dtype != torch.bfloat16:
        out = w_skip.new_zeros(layers, 2, hd, GAT_LAYER_N)
        out[:, 0, :, :hd] = w_skip.transpose(1, 2)
        out[:, 1, :, :hd] = w_proj.transpose(1, 2)
        return out
    kp = gat_layer_geometry(hd)[0]
    proj = w_proj.new_zeros(layers, hd, 2 * kp)
    proj[:, :, :hd] = w_proj
    proj[:, :, kp : kp + hd] = w_proj
    return torch.cat([linear_tiles(w_skip, GAT_LAYER_N), linear_tiles(proj, GAT_LAYER_N)], dim=1)


def gat_layer_tiles(w_skip: torch.Tensor, w_proj: torch.Tensor) -> torch.Tensor:
    """``gat_layer_pack`` of a weight set, packed once (``_pack_once``):
    the models pass ``skip_w[:L−1]`` and ``proj_w[1:]`` viewed as [L−1,
    H·D, H·D] and hand layer l its slice (``gat.layer_tiles``)."""
    return _pack_once(("gat_layer",), (w_skip, w_proj), lambda: gat_layer_pack(w_skip, w_proj))


def _linear_operand(lib, dims_fn: str, d: int, tiles, k: int, n: int, layers: int, pack,
                    dev) -> torch.Tensor:
    """A bf16 product's weight chunks: ``tiles`` as given, checked, or packed
    here (``pack()``). The kernel's geometry at width ``d`` (``dims_fn``:
    K', N, the bytes of a chunk) must be the host's for K = ``k``."""
    _check_linear_dims(lib, dims_fn, d, k, n)
    _, chunks, elems = linear_geometry(k, n)
    if tiles is None:
        tiles = pack()
    _check("weight tiles", tiles, torch.bfloat16, (layers, chunks, elems), dev)
    return tiles


def _check_linear_dims(lib, dims_fn: str, d: int, k: int, n: int) -> None:
    """Raise unless the kernel's bf16 product geometry at width ``d``
    (``dims_fn``: K', N, the bytes of a chunk) is the host's for K = ``k``
    and width ``n`` (``linear_geometry``)."""
    kp, _, elems = linear_geometry(k, n)
    dims = (ctypes.c_int * 3)()
    lib[dims_fn](d, dims)
    if tuple(dims) != (kp, n, elems * 2):
        raise RuntimeError(f"the kernel's product geometry {tuple(dims)} is not the host's "
                           f"{(kp, n, elems * 2)}")


def _check_mlp_dims(lib, d: int, hid: int) -> None:
    """Raise unless the kernel's bf16 MLP geometry (``_mlp_dims``) at width
    ``d`` and hidden width ``hid`` is the host's (``gin_mlp_geometry``)."""
    dp, hp, n2, _, elems = gin_mlp_geometry(d, hid)
    dims = (ctypes.c_int * 4)()
    lib["mlp_dims"](d, hid, dims)
    if tuple(dims) != (dp, hp, n2, elems * 2):
        raise RuntimeError(f"the kernel's MLP geometry {tuple(dims)} is not the host's "
                           f"{(dp, hp, n2, elems * 2)}")


def _mlp_operand(lib, tiles, w1_all, w2_all, num_layers: int, per_layer: bool) -> torch.Tensor:
    """The bf16 kernel's weight chunks: ``tiles`` as given (the whole stack,
    or one layer's when ``per_layer``), checked, or packed here from the
    weights (``mlp_tiles``). The kernel's geometry (``_mlp_dims``) must be
    the host's; ``lib`` None: the caller's launch plan checked it."""
    d, hid = w1_all.shape[1], w1_all.shape[0] // num_layers
    _, _, _, chunks, elems = gin_mlp_geometry(d, hid)
    if lib is not None:
        _check_mlp_dims(lib, d, hid)
    if tiles is None:
        tiles = mlp_tiles(w1_all, w2_all, num_layers)
        tiles = tiles[0] if per_layer else tiles
    shape = (chunks, elems) if per_layer else (num_layers, chunks, elems)
    _check("mlp_tiles", tiles, torch.bfloat16, shape, w1_all.device)
    return tiles


def ring_stages(smem_of, chunks: int, budget: int) -> int:
    """The bf16 MLP's weight ring: the most chunk buffers, up to the
    ``chunks`` of a layer, whose block footprint ``smem_of(stages)`` fits
    ``budget`` bytes, and at least two (one when a layer has one chunk):
    chunk c + 1 is loaded into chunk c − 1's buffer after the MLP has waited
    for chunk c, so one buffer would wait on itself. When none fits, the
    least; the footprint check then raises."""
    least = min(2, chunks)
    for stages in range(chunks, least - 1, -1):
        if smem_of(stages) <= budget:
            return stages
    return least


def _launch_gin_ell(ell_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
                    eps_all, pred_w, window, num_layers, gmax, vn_col, tiles,
                    knockout=0) -> torch.Tensor:
    dev = h0.device
    n = h0.shape[0]
    nw = -(-n // window)
    block = _ell_block(ell_meta, nw, dev)
    lib = _library("gin_local_model")
    return _launch_gin_model(gin_local_model, lib, ell_meta, block, h0, pool_gl, ee_tables,
                             w1_all, b1_all, w2_all, b2_all, eps_all, pred_w, window, num_layers,
                             gmax, vn_col, tiles, knockout=knockout)


def _launch_gin_model(fn, lib, meta, layout_arg, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                      b2_all, eps_all, pred_w, window, num_layers, gmax, vn_col, tiles,
                      slot_geom=None, knockout=0) -> torch.Tensor:
    """Launch row 8 (``layout_arg`` the ELL block) or row 1 (the slot
    centre, ``slot_geom`` = (caps, slots)) of ``csrc/gin_model.cuh`` for the
    wrapper ``fn``: in bf16 with the weight ring as deep as the card's
    shared memory allows (``fn.stages``; 0 in f32), with ``knockout``'s
    ``GIN_KNOCKOUTS`` bits."""
    if not 0 <= knockout <= sum(GIN_KNOCKOUTS.values()):
        raise ValueError(f"knockout {knockout}: the bits of {GIN_KNOCKOUTS}")
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    L = num_layers
    vocab, hid, t_out = _check_gin(h0, pool_gl, ee_tables, w1_all, b1_all, w2_all,
                                   b2_all, eps_all, pred_w, vn_col, window, L)
    smem_of = lambda stages: lib["smem_bytes"](code, d, hid, vocab, gmax, t_out, stages)
    _check_tile(lib, d)
    stages = 0
    if code == 1:  # the wgmma MLP reads W1 and W2 as packed chunks
        tiles = _mlp_operand(lib, tiles, w1_all, w2_all, L, per_layer=False)
        stages = ring_stages(smem_of, gin_mlp_geometry(d, hid)[3],
                              lib["smem_optin"](dev.index))
    if slot_geom is None:
        _check_ell_geometry(lib, d, window, smem_of(stages), dev)
        geom_args = ()
    else:
        caps, slots = slot_geom
        _check_ell_geometry(lib, d, window, smem_of(stages), dev)
        _check_geometry(lib, d, slots, caps, window, smem_of(stages), dev)
        geom_args = ((ctypes.c_int * len(caps))(*caps), slots)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        meta.data_ptr(), h0.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), w1_all.data_ptr(), b1_all.data_ptr(),
        w2_all.data_ptr(), b2_all.data_ptr(), eps_all.data_ptr(),
        pred_w.data_ptr(), None if vn_col is None else vn_col.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(),
        nw, n, window, layout_arg, d, hid, L, vocab, gmax, t_out, *geom_args, stages,
        int(knockout), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, fn.__name__)
    fn.launches += 1
    fn.stages = stages
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
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """GIN / GIN-VN whole-model ELL kernel: [NW·GMAX, T] f32 per-window
    pool sums over the k=1 ELL layout, at windows of 128 up to 1024 rows.

    Operands as in ``gin_local_model_ref``. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (float32 or bfloat16
    activations and weights, int32 ``ell_meta`` / ``pool_gl``, float32
    ``eps_all``) or raises. In bfloat16 the kernel's update MLP runs on the
    tensor cores (``wgmma``) from ``mlp_tiles``, as in
    ``gin_local_model_slots``; ``gin_local_model.stages`` records the weight
    ring. A width it cannot take (D > 112) raises. ``knockout`` as in
    ``gin_local_model_slots``. Each launch adds one to
    ``gin_local_model.launches``."""
    args = (ell_meta, h0, pool_gl, ee_tables, w1_all, b1_all, w2_all, b2_all,
            eps_all, pred_w, window, num_layers, gmax, vn_col, mlp_tiles, knockout)
    return _dispatch(h0, gin_local_model_ref, _launch_gin_ell, args)


gin_local_model.launches = 0
gin_local_model.stages = 0


def _two_blocks_budget(lib, dev) -> int:
    """The shared memory a block may take for two blocks an SM (or the
    opt-in limit, where that is less)."""
    per_sm = lib["smem_per_sm"](dev.index)
    if per_sm < 0:
        raise RuntimeError(lib["error_string"](int(-per_sm)).decode())
    return min(lib["smem_optin"](dev.index), per_sm // 2 - 1024)


def _knocked_out(h0: torch.Tensor, knockout: int) -> bool:
    """Whether a launch knocks a stage out (a timing knob the models never
    set) in a kernel whose knockouts have no plain version (rows 1 and 8's
    have one, ``GIN_KNOCKOUTS``): only the CUDA kernel has them."""
    if knockout and h0.device.type != "cuda":
        raise ValueError("knockout times the CUDA kernel; it has no plain version")
    return bool(knockout)


def _launch_gcn_ell(ell_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                    wn_all, bn_all, pred_w, window, num_layers, gmax, tiles,
                    knockout=0) -> torch.Tensor:
    code = _dtype_code(h0.dtype)
    dev = h0.device
    n, d = h0.shape
    nw = -(-n // window)
    L = num_layers
    vocab, t_out = _check_gcn(h0, dis, pool_gl, ee_tables, roots, alphas, betas,
                              wn_all, bn_all, pred_w, window, L)
    block = _ell_block(ell_meta, nw, dev)

    lib = _library("gcn_local_model")
    tiles, stages, smem = _gcn_conv_operand(lib, code, d, vocab, gmax, t_out, L, wn_all, tiles, dev)
    _check_ell_geometry(lib, d, window, smem, dev)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        ell_meta.data_ptr(), h0.data_ptr(), dis.data_ptr(), pool_gl.data_ptr(),
        ee_tables.data_ptr(), roots.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), wn_all.data_ptr(), bn_all.data_ptr(),
        pred_w.data_ptr(), None if code == 0 else tiles.data_ptr(), out.data_ptr(),
        nw, n, window, block, d, L, vocab, gmax, t_out, stages, int(knockout),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gcn_local_model")
    gcn_local_model.launches += 1
    gcn_local_model.stages = stages
    return out


def _gcn_conv_operand(lib, code: int, d: int, vocab: int, gmax: int, t_out: int, L: int,
                      wn_all: torch.Tensor, tiles, dev):
    """Rows 9 and 2's next-conv operand: (the bf16 weight chunks, checked or
    packed here; None in f32), the weight ring's depth (0 in f32) and the
    block's shared memory. Raises on a D the kernel's tiles do not take."""
    _check_tile(lib, d)
    if d % 2:
        raise ValueError(f"D={d}: the kernel reads column pairs, D must be even")
    if code == 1:  # the wgmma conv reads the next convs' weights as packed chunks
        tiles = _linear_operand(
            lib, "conv_dims", d, tiles, d, gcn_conv_n(d), L - 1,
            lambda: gcn_conv_tiles(wn_all.view(L - 1, d, d).transpose(1, 2)), dev)
    stages = _two_block_stages("gcn_local_model", lib, code, (d, vocab), gmax, t_out, dev)
    return tiles, stages, lib["smem_bytes"](code, d, vocab, gmax, t_out, stages)


def _product_kn(kernel: str, d: int) -> tuple[int, int]:
    """(K, N) of the bf16 product of a kernel that keeps two blocks an SM,
    at width ``d``: rows 9 and 2's next conv, row 4's posttrans, row 5's
    glue."""
    if kernel.startswith("gcn_local_model"):
        return d, gcn_conv_n(d)
    if kernel == "dgn_local_model":
        return 2 * d, gcn_conv_n(d)
    return d, 2 * GAT_PITCH


def _two_block_stages(kernel: str, lib, code: int, geometry: tuple, gmax: int, t_out: int,
                      dev) -> int:
    """The weight ring of a bf16 kernel that keeps two blocks an SM: the
    deepest whose block fits half the SM's shared memory (``ring_stages``;
    0 in f32). ``geometry`` are the library's ``_smem_bytes`` arguments
    before (gmax, T, stages)."""
    if code == 0:
        return 0
    k, n = _product_kn(kernel, geometry[0])
    return ring_stages(lambda stages: lib["smem_bytes"](code, *geometry, gmax, t_out, stages),
                       linear_geometry(k, n)[1], _two_blocks_budget(lib, dev))


def occupancy(kernel: str, dtype: torch.dtype, window: int, geometry: tuple, gmax: int,
              t_out: int, device) -> dict:
    """What the occupancy calculator says of the cluster kernel ``kernel``
    (the libraries of rows 9, 2, 4 and 5, and of rows 20, 22, 18, 15, 14, 16
    and 19) in ``dtype`` at this geometry on ``device`` (the launch's own
    ring depth): the block's shared memory, the blocks of that form one SM
    holds, and the clusters of W/128 blocks that run at once. ``geometry``:
    (D, vocab) for GCN and rows 15 and 14, (D,) for DGN and rows 20, 22, 18
    and 16, (D,) for row 19 at its deepest slot table (8 slots), (H·D, heads)
    for GAT; rows 20, 22, 18, 15, 14, 16 and 19 have no pool head and ignore
    ``gmax`` and ``t_out``."""
    code = _dtype_code(dtype)
    dev = torch.device(device)
    lib = _library(kernel)
    out = (ctypes.c_int * 2)()
    if kernel == "pna_local_stats_slots":  # row 19 at its deepest slot table
        geometry = (geometry[0], lib["max_slots"]())
        stages, smem = _layer_plan(kernel, code, *geometry, window, dev.index)
        rc = lib["occupancy"](code, window, *geometry, dev.index, out)
    elif kernel in _NO_PRODUCT:  # rows 14 and 16: no product, no ring
        stages, smem = _layer_plan(kernel, code, geometry[0], 0, window, dev.index, *geometry[1:])
        rc = lib["occupancy"](code, window, *geometry, dev.index, out)
    elif kernel in _LAYER_PRODUCTS:
        stages = _layer_ring(kernel, lib, code, geometry, dev)
        smem = lib["smem_bytes"](code, *geometry, stages)
        rc = lib["occupancy"](code, window, *geometry, stages, dev.index, out)
    else:
        stages = _two_block_stages(kernel, lib, code, geometry, gmax, t_out, dev)
        smem = lib["smem_bytes"](code, *geometry, gmax, t_out, stages)
        rc = lib["occupancy"](code, window, *geometry, gmax, t_out, stages, dev.index, out)
    _raise_on(lib, rc, f"{kernel} occupancy")
    return dict(smem=smem, stages=stages, blocks_per_sm=out[0], clusters=out[1])


def layer_occupancy(kernel: str, dtype: torch.dtype, window: int, geometry: tuple,
                    device) -> dict:
    """What the occupancy calculator says of a per-layer kernel whose launch
    plan is cached (``GIN_LAYER_LIBRARIES``, ``gat_local_layer_ell``,
    ``GIN_MESSAGE_LIBRARIES``) in ``dtype`` at this geometry on ``device``
    (the launch's own plan): the block's shared memory, the weight ring, the
    blocks of that form one SM holds. ``geometry``: (D, H) for GIN (row 13:
    (D, H, vocab)), (H·D, heads) for GAT, (D, vocab) for row 31, (D,) for row
    12's pass-through."""
    code = _dtype_code(dtype)
    dev = torch.device(device)
    lib = _library(kernel)
    if kernel == "gat_local_layer_ell":
        stages, smem = _gat_layer_plan(code, *geometry, window, dev.index)
        args = (code, geometry[1], smem)
    elif kernel in GIN_MESSAGE_LIBRARIES:
        stages, smem = _layer_plan(kernel, code, geometry[0], 0, window, dev.index, *geometry[1:])
        args = (code, smem)
    else:
        d, hid, *vocab = geometry
        stages, smem = _gin_layer_plan(kernel, code, d, hid, vocab[0] if vocab else 0, window,
                                       dev.index)
        args = (code, d, hid, smem)
    out = (ctypes.c_int * 1)()
    _raise_on(lib, lib["occupancy"](*args, out), f"{kernel} occupancy")
    return dict(smem=smem, stages=stages, blocks_per_sm=out[0])


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
    conv_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """GCN whole-model ELL kernel (after conv 0): [NW·GMAX, T] f32
    per-window pool sums over the k=1 ELL layout, at windows of 128 up to
    1024 rows. Operands as in ``gcn_local_model_ref``; a CPU tensor runs the
    plain version, a CUDA tensor launches the kernel (float32 or bfloat16
    activations, norms and weights, int32 ``ell_meta`` / ``pool_gl``; D even,
    at most 112) or raises. In bfloat16 the next conv runs on the tensor
    cores (``wgmma``) from ``conv_tiles``, the next convs' weight chunks as
    ``gcn_conv_tiles`` packs them (packed here, once per weight set, when
    not given); ``gcn_local_model.stages`` records the launch's weight ring
    (0 in float32). ``knockout`` (timing only, CUDA only): bit 0 skips the
    next conv, bit 1 the messages. Each launch adds one to
    ``gcn_local_model.launches``."""
    args = (ell_meta, h0, dis, pool_gl, ee_tables, roots, alphas, betas,
            wn_all, bn_all, pred_w, window, num_layers, gmax, conv_tiles)
    if _knocked_out(h0, knockout):
        return _launch_gcn_ell(*args, knockout=knockout)
    return _dispatch(h0, gcn_local_model_ref, _launch_gcn_ell, args)


gcn_local_model.launches = 0
gcn_local_model.stages = 0


def _launch_pna(slot_src, h0, inv_deg, t, scale, w_all, b_all, pool_gl, mlp1_w,
                window, slots, num_layers, gmax, min_init, max_init,
                prefix_caps, tiles, knockout=0) -> torch.Tensor:
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
    _check_tile(lib, d)
    smem_of = lambda stages: lib["smem_bytes"](code, d, gmax, t_out, stages)
    stages = 0
    if code == 1:  # the wgmma tower reads the weights as packed chunks
        n_tower = 3 * PNA_PITCH
        tiles = _linear_operand(
            lib, "tower_dims", d, tiles, 4 * d, n_tower, L,
            lambda: pna_tower_tiles(w_all.view(L, 4 * d, 3, d).permute(0, 2, 3, 1)), dev)
        stages = ring_stages(smem_of, linear_geometry(4 * d, n_tower)[1],
                             lib["smem_optin"](dev.index))
    _check_ell_geometry(lib, d, window, smem_of(stages), dev)
    _check_geometry(lib, d, slots, caps, window, smem_of(stages), dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_src.data_ptr(), h0.data_ptr(), inv_deg.data_ptr(), t.data_ptr(),
        scale.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
        pool_gl.data_ptr(), mlp1_w.data_ptr(), None if code == 0 else tiles.data_ptr(),
        out.data_ptr(), nw, n, window, d, L, gmax, t_out, float(min_init), float(max_init),
        caps_arr, slots, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "pna_local_model")
    pna_local_model.launches += 1
    pna_local_model.stages = stages
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
    tower_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """PNA whole-model slot megakernel (conv stack + readout MLP-1):
    [NW·GMAX, T] f32 per-window pool sums, at windows of 128 up to 1024 rows
    (one thread-block cluster of W/128 blocks per window). Operands as in
    ``pna_local_model_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 activations, scalers
    and weights, int32 ``slot_src`` / ``pool_gl``; D at most 80) or raises.
    In bfloat16 the tower runs on the tensor cores (``wgmma``) from
    ``tower_tiles``, the weight chunks as ``pna_tower_tiles`` packs them
    (packed here, once per weight set, when not given);
    ``pna_local_model.stages`` records the launch's weight ring (0 in
    float32). ``knockout`` (timing only, CUDA only): bit 0 skips the tower's
    product, bit 1 the stats. Each launch adds one to
    ``pna_local_model.launches``."""
    args = (slot_src, h0, inv_deg, t, scale, w_all, b_all, pool_gl, mlp1_w,
            window, slots, num_layers, gmax, min_init, max_init, prefix_caps, tower_tiles)
    if _knocked_out(h0, knockout):
        return _launch_pna(*args, knockout=knockout)
    return _dispatch(h0, pna_local_model_ref, _launch_pna, args)


pna_local_model.launches = 0
pna_local_model.stages = 0


def _launch_dgn(slot_src, h0, eig, inv_deg, eigw_sum, inv_abssum, w_all, b_all,
                pool_gl, mlp1_w, window, slots, num_layers, gmax,
                prefix_caps, tiles, knockout=0) -> torch.Tensor:
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
    _check_tile(lib, d)
    if code == 1:  # the wgmma posttrans reads the weights as packed chunks
        tiles = _linear_operand(
            lib, "posttrans_dims", d, tiles, 2 * d, gcn_conv_n(d), L,
            lambda: dgn_posttrans_tiles(w_all.view(L, 2 * d, d).transpose(1, 2)), dev)
    stages = _two_block_stages("dgn_local_model", lib, code, (d,), gmax, t_out, dev)
    smem = lib["smem_bytes"](code, d, gmax, t_out, stages)
    _check_ell_geometry(lib, d, window, smem, dev)
    _check_geometry(lib, d, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_src.data_ptr(), h0.data_ptr(), eig.data_ptr(), inv_deg.data_ptr(),
        eigw_sum.data_ptr(), inv_abssum.data_ptr(), w_all.data_ptr(),
        b_all.data_ptr(), pool_gl.data_ptr(), mlp1_w.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(),
        nw, n, window, d, L, gmax, t_out,
        caps_arr, slots, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_model")
    dgn_local_model.launches += 1
    dgn_local_model.stages = stages
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
    posttrans_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """DGN whole-model slot megakernel (conv stack + readout MLP-1):
    [NW·GMAX, T] f32 per-window pool sums, at windows of 128 up to 1024 rows
    (one thread-block cluster of W/128 blocks per window). Operands as in
    ``dgn_local_model_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 activations, per-node
    terms and weights, int32 ``slot_src`` / ``pool_gl``; D at most 112) or
    raises. In bfloat16 the posttrans runs on the tensor cores (``wgmma``)
    from ``posttrans_tiles`` as ``dgn_posttrans_tiles`` packs them (packed
    here, once per weight set, when not given); ``dgn_local_model.stages``
    records the launch's weight ring (0 in float32). ``knockout`` (timing
    only, CUDA only): bit 0 skips the posttrans product, bit 1 the channels.
    Each launch adds one to ``dgn_local_model.launches``."""
    args = (slot_src, h0, eig, inv_deg, eigw_sum, inv_abssum, w_all, b_all,
            pool_gl, mlp1_w, window, slots, num_layers, gmax, prefix_caps, posttrans_tiles)
    if _knocked_out(h0, knockout):
        return _launch_dgn(*args, knockout=knockout)
    return _dispatch(h0, dgn_local_model_ref, _launch_dgn, args)


dgn_local_model.launches = 0
dgn_local_model.stages = 0


def _launch_gat(slot_pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl, pred_hd,
                window, slots, num_heads, num_layers, gmax,
                prefix_caps, tiles, knockout=0) -> torch.Tensor:
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
    _check_tile(lib, hd)
    if code == 1:  # the wgmma glue reads the next layers' weights as packed chunks
        right_t = lambda w: w.view(L - 1, hd, hd).transpose(1, 2)
        tiles = _linear_operand(
            lib, "glue_dims", hd, tiles, hd, 2 * GAT_PITCH, L - 1,
            lambda: gat_glue_tiles(right_t(proj_w), right_t(skip_w)), dev)
    stages = _two_block_stages("gat_local_model_slots", lib, code, (hd, nh), gmax, t_out, dev)
    smem = lib["smem_bytes"](code, hd, nh, gmax, t_out, stages)
    _check_ell_geometry(lib, hd, window, smem, dev)
    _check_geometry(lib, hd, slots, caps, window, smem, dev)
    caps_arr = (ctypes.c_int * len(caps))(*caps)
    out = torch.empty((nw * gmax, t_out), dtype=torch.float32, device=dev)
    rc = lib["launch"](
        code,
        slot_pstack.data_ptr(), h0.data_ptr(), skip0.data_ptr(), proj_w.data_ptr(),
        skip_w.data_ptr(), a_all.data_ptr(), pool_gl.data_ptr(),
        pred_hd.data_ptr(), None if code == 0 else tiles.data_ptr(), out.data_ptr(),
        nw, n, window, hd, nh, L, gmax, t_out,
        caps_arr, slots, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gat_local_model_slots")
    gat_local_model_slots.launches += 1
    gat_local_model_slots.stages = stages
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
    glue_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """GAT whole-model slot megakernel: [NW·GMAX, T] f32 per-window pool
    sums, at windows of 128 up to 1024 rows (one thread-block cluster of
    W/128 blocks per window). Operands as in ``gat_local_model_slots_ref``;
    a CPU tensor runs the plain version, a CUDA tensor launches the kernel
    (float32 or bfloat16 activations and weights, int32 ``slot_pstack`` /
    ``pool_gl``; H·D at most 64) or raises. In bfloat16 the glue
    feat·[proj ‖ skip] runs on the tensor cores (``wgmma``) from
    ``glue_tiles`` as ``gat_glue_tiles`` packs them (packed here, once per
    weight set, when not given); ``gat_local_model_slots.stages`` records
    the launch's weight ring (0 in float32). ``knockout`` (timing only, CUDA
    only): bit 0 skips the glue's product, bit 1 the messages. Each launch
    adds one to ``gat_local_model_slots.launches``."""
    args = (slot_pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl, pred_hd,
            window, slots, num_heads, num_layers, gmax, prefix_caps, glue_tiles)
    if _knocked_out(h0, knockout):
        return _launch_gat(*args, knockout=knockout)
    return _dispatch(h0, gat_local_model_slots_ref, _launch_gat, args)


gat_local_model_slots.launches = 0
gat_local_model_slots.stages = 0


def _launch_pna_stats(slot_src, h, window, slots, min_init, max_init,
                      knockout=0) -> torch.Tensor:
    code = _dtype_code(h.dtype)
    dev = h.device
    n, d = h.shape
    name = "pna_local_stats_slots"
    lib = _library(name)
    _layer_plan(name, code, d, slots, window, dev.index)
    nw = -(-n // window)
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h", h, h.dtype, (n, d), dev)
    out = torch.empty((n, 4 * d), dtype=h.dtype, device=dev)
    rc = lib["launch"](
        code, slot_src.data_ptr(), h.data_ptr(), out.data_ptr(),
        nw, n, window, d, slots, float(min_init), float(max_init), int(knockout),
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
    knockout: int = 0,
) -> torch.Tensor:
    """PNA's four slot aggregates of one layer: [n, 4D] [sum ‖ sum² ‖ min ‖
    max] in h's dtype (``csrc/pna_local_stats_slots.cu``, the counterpart of
    the TPU kernel ``pna_local_stats_ell``, which also runs over the slot
    layout: the stats-only form of row 3's cluster kernel, a cluster of
    W/128 blocks per window of 128 to 1024 rows, any D from 1 to 128, 1 to 8
    slots). Operands as in ``pna_local_stats_ell_ref``; note the order of
    the seeds: the PNA model passes (MAX_INIT, MIN_INIT), the min's seed
    first. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (float32 or bfloat16 h, int32 ``slot_src``; its plan from
    ``_layer_plan``) or raises. ``knockout`` (timing only, CUDA only): bit 1
    skips the stats (zeros are written). Each launch adds one to
    ``pna_local_stats_ell.launches``."""
    args = (slot_src, h, window, slots, min_init, max_init)
    if _knocked_out(h, knockout):
        return _launch_pna_stats(*args, knockout=knockout)
    return _dispatch(h, pna_local_stats_ell_ref, _launch_pna_stats, args)


pna_local_stats_ell.launches = 0


# The bf16 product of rows 20, 22 and 18 (the one-layer forms of rows 3 and
# 4, row 18 over the ELL layout), by library: the getter of its chunk
# geometry, and its (K, N) at width D.
_LAYER_PRODUCTS = {
    "pna_local_layer_slots": ("tower_dims", lambda d: (4 * d, 3 * PNA_PITCH)),
    "dgn_local_layer_slots": ("posttrans_dims", lambda d: (2 * d, gcn_conv_n(d))),
    "dgn_local_layer_ell_model": ("posttrans_dims", lambda d: (2 * d, gcn_conv_n(d))),
    "gcn_local_layer_ell": ("conv_dims", lambda d: (d, gcn_conv_n(d))),
}


def _layer_ring(name: str, lib, code: int, geometry: tuple, dev) -> int:
    """The bf16 weight ring of the one-layer kernels (0 in f32) at
    ``geometry`` ((D,), or row 15's (D, vocab)): rows 22, 18 and 15
    (``dgn_local_layer_slots``, ``dgn_local_layer_ell_model``,
    ``gcn_local_layer_ell``) the deepest that keeps two blocks an SM, as
    rows 4 and 9; row 20 (``pna_local_layer_slots``) the deepest that fits a
    block, as row 3 (its stats alone take 80 KB at D = 80: one block an
    SM)."""
    if code == 0:
        return 0
    chunks = linear_geometry(*_LAYER_PRODUCTS[name][1](geometry[0]))[1]
    budget = (lib["smem_optin"](dev.index) if name == "pna_local_layer_slots"
              else _two_blocks_budget(lib, dev))
    return ring_stages(lambda stages: lib["smem_bytes"](code, *geometry, stages), chunks, budget)


# The messages-only forms of rows 13 and 12 (row 31 and row 12's
# pass-through).
GIN_MESSAGE_LIBRARIES = ("gin_local_message_ell", "gin_local_message_lanes")
# The messages-, channels- and stats-only forms of rows 9, 4, 3, 13 and 12
# (rows 14, 16, 19, 31 and row 12's pass-through), by library: no product, no
# ring.
_NO_PRODUCT = ("gcn_local_message_ell", "dgn_local_layer_ell", "pna_local_stats_slots",
               *GIN_MESSAGE_LIBRARIES)


@functools.cache
def _layer_plan(name: str, code: int, d: int, slots: int, window: int, device: int,
                vocab: int = 0) -> tuple:
    """The launch plan of rows 20, 22, 18, 15, 14, 16, 19, 31 and row 12's
    pass-through (``slots`` 0: the ELL lanes of rows 18, 15, 14, 16, 31 and
    the pass-through; ``vocab``: rows 15, 14 and 31's bond table) at this
    geometry on CUDA device ``device``, worked out once per geometry (a
    launch is tens of µs, and these checks take the library's getters): (the
    weight ring, the block's shared memory; rows 14, 16, 19, 31 and the
    pass-through have no product and no ring). Raises before launch on what
    the clusters or windows (whole blocks of 128 rows, at most 8), the tile
    (row 15: an even D; rows 14, 16, 19, 31 and the pass-through: D at most
    128), the slot depth or the card's shared memory do not take, or a
    product geometry the host does not share; a refusal is not cached."""
    lib = _library(name)
    dev = torch.device("cuda", device)
    _check_tile(lib, d)
    if name.startswith("gcn_local") or name == "gin_local_message_ell":
        geometry = (d, vocab)
    elif name == "pna_local_stats_slots":
        geometry = (d, slots)
    else:
        geometry = (d,)
    if name == "gcn_local_layer_ell" and d % 2:
        raise ValueError(f"D={d}: the kernel's tile takes an even D")
    if name in _NO_PRODUCT:
        smem = lib["smem_bytes"](code, *geometry)
        _check_ell_geometry(lib, d, window, smem, dev)
        if slots:
            _check_geometry(lib, d, slots, (window,), window, smem, dev)
        return 0, smem
    if code == 1:
        dims_fn, kn = _LAYER_PRODUCTS[name]
        _check_linear_dims(lib, dims_fn, d, *kn(d))
    stages = _layer_ring(name, lib, code, geometry, dev)
    smem = lib["smem_bytes"](code, *geometry, stages)
    _check_ell_geometry(lib, d, window, smem, dev)
    if slots:
        _check_geometry(lib, d, slots, (window,), window, smem, dev)
    return stages, smem


def _layer_tiles(name: str, d: int, tiles, pack, dev) -> torch.Tensor:
    """Rows 20, 22, 18 and 15's bf16 weight chunks of one layer: ``tiles`` as
    given, or packed here (``pack()``), checked as [C, 32·N]."""
    _, chunks, elems = linear_geometry(*_LAYER_PRODUCTS[name][1](d))
    if tiles is None:
        tiles = pack()
    _check("weight tiles", tiles, torch.bfloat16, (chunks, elems), dev)
    return tiles


# The largest dynamic shared memory each per-layer library's kernels were
# opted in to, by (library, device): the limit only rises, so every launch
# plan made before stays valid.
_PREPARED: dict = {}


def _prepare(name: str, lib, smem: int, device: int) -> None:
    """Opt library ``name``'s kernels in to ``smem`` bytes of dynamic shared
    memory on CUDA device ``device``, unless an earlier plan did already."""
    if _PREPARED.get((name, device), -1) >= smem:
        return
    _raise_on(lib, lib["prepare"](smem, device), f"{name} prepare")
    _PREPARED[name, device] = smem


@functools.cache
def _gin_layer_plan(name: str, code: int, d: int, hid: int, vocab: int, window: int,
                    device: int) -> tuple:
    """The launch plan of the per-layer GIN kernels (``GIN_LAYER_LIBRARIES``:
    rows 13, 10 / 12 and 25) at this geometry on CUDA device ``device``,
    worked out once per geometry: (the bf16 weight ring, the block's shared
    memory). The ring is the deepest that keeps two blocks an SM (0 in f32);
    ``vocab`` is row 13's bond table (0 for the others). Raises before
    launch on what the window (whole blocks of 128 rows, at most 8), the tile
    or the card's shared memory do not take, or an MLP geometry the host does
    not share; a refusal is not cached."""
    lib = _library(name)
    dev = torch.device("cuda", device)
    _check_tile(lib, d)
    table = (vocab,) if name == "gin_local_layer_ell" else ()
    smem_of = lambda stages: lib["smem_bytes"](code, d, hid, *table, stages)
    stages = 0
    if code == 1:  # the wgmma MLP
        _check_mlp_dims(lib, d, hid)
        stages = ring_stages(smem_of, gin_mlp_geometry(d, hid)[3], _two_blocks_budget(lib, dev))
    smem = smem_of(stages)
    _check_ell_geometry(lib, d, window, smem, dev)
    _prepare(name, lib, smem, device)
    return stages, smem


def _check_pairs(*named) -> None:
    """The kernels read these rows as column pairs: raise unless each
    (name, tensor or None) starts on a pair."""
    for name, t in named:
        if t is not None and t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name}: rows are read as pairs; its data must be "
                             f"{2 * t.element_size()}-byte aligned")


def _launch_dgn_layer(slot_src, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post,
                      window, slots, m_spill, tiles, knockout=0) -> torch.Tensor:
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

    name = "dgn_local_layer_slots"
    lib = _library(name)
    stages, _ = _layer_plan(name, code, d, slots, window, dev.index)
    if code == 1:  # the wgmma posttrans reads the layer's weights as packed chunks
        tiles = _layer_tiles(name, d, tiles, lambda: dgn_layer_tiles(w_post), dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, slot_src.data_ptr(), h.data_ptr(), eig.data_ptr(), inv_deg.data_ptr(),
        eigw_sum.data_ptr(), inv_abssum.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
        None if m_spill is None else m_spill.data_ptr(), None if code == 0 else tiles.data_ptr(),
        out.data_ptr(), nw, n, window, d, slots, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_layer_slots")
    dgn_local_layer_slots.launches += 1
    dgn_local_layer_slots.stages = stages
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
    posttrans_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole DGN layer over the slot layout: the next h [n, D] in h's
    dtype, at windows of 128 up to 1024 rows (``csrc/dgn_local_layer_slots.cu``,
    one layer of row 4's cluster kernel). Operands as in
    ``dgn_local_layer_slots_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h, node terms,
    weights and ``m_spill``, int32 ``slot_src``; D at most 112) or raises.
    In bfloat16 the posttrans runs on the tensor cores (``wgmma``) from
    ``posttrans_tiles``, this layer's [C, 32·N] chunks of
    ``dgn_posttrans_tiles`` (packed here by ``dgn_layer_tiles``, once per
    weight set, when not given); ``dgn_local_layer_slots.stages`` records the launch's weight ring
    (0 in float32). ``knockout`` (timing only, CUDA only): bit 0 skips the
    posttrans product, bit 1 the channels. Each launch adds one to
    ``dgn_local_layer_slots.launches``."""
    args = (slot_src, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post,
            window, slots, m_spill, posttrans_tiles)
    if _knocked_out(h, knockout):
        return _launch_dgn_layer(*args, knockout=knockout)
    return _dispatch(h, dgn_local_layer_slots_ref, _launch_dgn_layer, args)


dgn_local_layer_slots.launches = 0
dgn_local_layer_slots.stages = 0


@functools.cache
def _gat_message_plan(hd: int, heads: int, slots: int, window: int, device: int) -> int:
    """Row 21's launch plan at this geometry on CUDA device ``device``,
    worked out once per geometry: the block's shared memory (none). Raises
    before launch on what the window (whole blocks of 128 rows, at most 8),
    the tile, the heads, the slot depth or the card's shared memory do not
    take; a refusal is not cached."""
    lib = _library("gat_local_message_slots")
    dev = torch.device("cuda", device)
    if not 1 <= heads <= lib["max_heads"]():
        raise ValueError(f"num_heads={heads} outside 1..{lib['max_heads']()}")
    smem = lib["smem_bytes"](hd, heads)
    _check_ell_geometry(lib, hd, window, smem, dev)
    _check_geometry(lib, hd, slots, (window,), window, smem, dev)
    return smem


def _launch_gat_message(slot_stack, h, s_src, s_tgt, window, slots, num_heads, divide,
                        knockout=0) -> torch.Tensor:
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
    _gat_message_plan(hd, num_heads, slots, window, dev.index)
    lib = _library("gat_local_message_slots")
    out = torch.empty((n, hd if divide else hd + num_heads), dtype=dt, device=dev)
    rc = lib["launch"](
        code, slot_stack.data_ptr(), h.data_ptr(), s_src.data_ptr(), s_tgt.data_ptr(),
        out.data_ptr(), nw, n, window, hd, num_heads, slots, int(bool(divide)), int(knockout),
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
    knockout: int = 0,
) -> torch.Tensor:
    """GAT's edge softmax of one layer over the slot layout: [n, H·D]
    (``divide``) or [n, H·D + H] in h's dtype
    (``csrc/gat_local_message_slots.cu``: the message walk of rows 17 and 23,
    ``csrc/gat_messages.cuh``, over the slot rows). Operands as in
    ``gat_local_message_slots_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h and scores, int32
    ``slot_stack``; H·D at most 128, at most 32 heads, W up to 1024 in whole
    blocks of 128 rows) or raises. ``knockout`` (timing only, CUDA only): bit
    1 skips the messages. Each launch adds one to
    ``gat_local_message_slots.launches``."""
    args = (slot_stack, h, s_src, s_tgt, window, slots, num_heads, divide)
    if _knocked_out(h, knockout):
        return _launch_gat_message(*args, knockout=knockout)
    return _dispatch(h, gat_local_message_slots_ref, _launch_gat_message, args)


gat_local_message_slots.launches = 0


def _launch_pna_layer(slot_src, h, inv_deg, t, scale, w_cat, b, window, slots, min_init,
                      max_init, tiles, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    nw = -(-n // window)
    _check("slot_src", slot_src, torch.int32, (nw * window, slots), dev)
    _check("h", h, dt, (n, d), dev)
    for name, x in (("inv_deg", inv_deg), ("t", t), ("scale", scale)):
        _check(name, x, dt, (n,), dev)
    _check("w_cat", w_cat, dt, (4 * d, 3 * d), dev)
    _check("b", b, dt, (1, d), dev)

    name = "pna_local_layer_slots"
    lib = _library(name)
    stages, _ = _layer_plan(name, code, d, slots, window, dev.index)
    if code == 1:  # the wgmma tower reads the layer's weights as packed chunks
        tiles = _layer_tiles(name, d, tiles, lambda: pna_layer_tiles(w_cat), dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, slot_src.data_ptr(), h.data_ptr(), inv_deg.data_ptr(), t.data_ptr(),
        scale.data_ptr(), w_cat.data_ptr(), b.data_ptr(), None if code == 0 else tiles.data_ptr(),
        out.data_ptr(), nw, n, window, d, slots, float(min_init), float(max_init), stages,
        int(knockout), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "pna_local_layer")
    pna_local_layer.launches += 1
    pna_local_layer.stages = stages
    return out


def pna_local_layer(
    slot_src: torch.Tensor,
    h: torch.Tensor,
    inv_deg: torch.Tensor,
    t: torch.Tensor,
    scale: torch.Tensor,
    w_cat: torch.Tensor,
    b: torch.Tensor,
    window: int,
    slots: int,
    min_init: float,
    max_init: float,
    tower_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole PNA layer over a slot batch with no spill tail: the next h
    [n, D] in h's dtype, at windows of 128 up to 1024 rows
    (``csrc/pna_local_layer_slots.cu``, one layer of row 3's cluster
    kernel). Operands as in ``pna_local_layer_ref``; the seeds in the order
    of ``pna_local_stats_ell`` (the min's first). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (float32 or bfloat16 h,
    scalers and weights, int32 ``slot_src``; D at most 80) or raises. In
    bfloat16 the tower runs on the tensor cores (``wgmma``) from
    ``tower_tiles``, this layer's [C, 32·240] chunks of ``pna_tower_tiles``
    (packed here by ``pna_layer_tiles``, once per weight set, when not
    given);
    ``pna_local_layer.stages`` records the launch's weight ring (0 in
    float32). ``knockout`` (timing only, CUDA only): bit 0 skips the tower's
    product, bit 1 the stats. Each launch adds one to
    ``pna_local_layer.launches``."""
    args = (slot_src, h, inv_deg, t, scale, w_cat, b, window, slots, min_init, max_init,
            tower_tiles)
    if _knocked_out(h, knockout):
        return _launch_pna_layer(*args, knockout=knockout)
    return _dispatch(h, pna_local_layer_ref, _launch_pna_layer, args)


pna_local_layer.launches = 0
pna_local_layer.stages = 0


def _check_ell_lanes(ell_meta, h, window, library: str, smem_args):
    """Check h, the lanes and the geometry of a per-layer ELL kernel whose
    shared memory ``smem_bytes(*smem_args)`` gives; returns (the library,
    lanes per window, NW)."""
    dev = h.device
    n, d = h.shape
    nw = -(-n // window)
    _check("h", h, h.dtype, (n, d), dev)
    lanes = _ell_block(ell_meta, nw, dev)
    lib = _library(library)
    _check_ell_geometry(lib, d, window, lib["smem_bytes"](*smem_args), dev)
    return lib, lanes, nw


def _launch_gin_layer_ell(ell_meta, h, m_spill, ee_table, w1, b1, w2, b2, eps1, window,
                          final_relu, tiles, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    hid = check_gin_mlp(h, m_spill, w1, b1, w2, b2, eps1)
    vocab = ee_table.shape[0]
    _check("ee_table", ee_table, dt, (vocab, d), dev)
    _check_pairs(("h", h), ("m_spill", m_spill))
    name = "gin_local_layer_ell"
    lib = _library(name)
    stages, _ = _gin_layer_plan(name, code, d, hid, vocab, window, dev.index)
    if code == 1:  # the wgmma MLP reads the layer's weights as packed chunks
        tiles = _mlp_operand(None, tiles, w1, w2, 1, per_layer=True)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(),
        None if m_spill is None else m_spill.data_ptr(), ee_table.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), eps1.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(), nw, n, window, lanes, d, hid,
        vocab, int(bool(final_relu)), stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gin_local_layer_ell")
    gin_local_layer_ell.launches += 1
    gin_local_layer_ell.stages = stages
    return out


def gin_local_layer_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    m_spill: Optional[torch.Tensor],
    ee_table: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps1: torch.Tensor,
    window: int,
    final_relu: bool,
    ee: Optional[torch.Tensor] = None,
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole GIN / GIN-VN layer over the ELL layout: the next h [n, D]
    in h's dtype (``csrc/gin_local_layer_ell.cu``). Operands as in
    ``gin_local_layer_ell_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h, ``m_spill``,
    table and weights, int32 ``ell_meta``, float32 ``eps1``) or raises. In
    bfloat16 the update MLP runs on the tensor cores from ``mlp_tiles``,
    this layer's [C, (D' + N2)·32] slice of ``mlp_tiles()`` (packed here,
    once per weight set, when not given), through a weight ring as deep as
    two blocks an SM allow (``gin_local_layer_ell.stages``; 0 in float32).
    Each launch adds one to ``gin_local_layer_ell.launches``. With ``ee``
    [P, D], each lane's bond embedding, ``ee_table`` is not read (pass None)
    and the layer runs ``gin_local_layer_ell_lanes``, as the JAX function
    without ``edge_attr`` runs ``local_scatter_apply_ell``; one of the two
    must be given. ``knockout`` times the CUDA kernel without a stage (bit
    0 the MLP, bit 1 the messages; the models never set it)."""
    if ee is None and ee_table is None:
        raise ValueError("gin_local_layer_ell: neither ee_table nor ee given")
    if ee is not None:
        return gin_local_layer_ell_lanes(ee, ell_meta, h, m_spill, w1, b1, w2, b2, eps1, window,
                                         final_relu, mlp_tiles, knockout)
    args = (ell_meta, h, m_spill, ee_table, w1, b1, w2, b2, eps1, window, final_relu, mlp_tiles)
    if _knocked_out(h, knockout):
        return _launch_gin_layer_ell(*args, knockout=knockout)
    return _dispatch(h, gin_local_layer_ell_ref, _launch_gin_layer_ell, args)


gin_local_layer_ell.launches = 0
gin_local_layer_ell.stages = 0


def check_gin_mlp(h, m_spill, w1, b1, w2, b2, eps1) -> int:
    """Check a per-layer GIN kernel's h, ``m_spill`` and MLP operands;
    returns the hidden width."""
    dt, dev = h.dtype, h.device
    n, d = h.shape
    hid = w1.shape[0]
    _check("h", h, dt, (n, d), dev)
    if m_spill is not None:
        _check("m_spill", m_spill, dt, (n, d), dev)
    _check("w1", w1, dt, (hid, d), dev)
    _check("b1", b1, dt, (hid,), dev)
    _check("w2", w2, dt, (d, hid), dev)
    _check("b2", b2, dt, (d,), dev)
    _check("eps1", eps1, torch.float32, (1, 1), dev)
    return hid


def _launch_gin_layer_blocks(counted, ee, u_local, v_local, block_window, blocks, h, m_spill,
                             w1, b1, w2, b2, eps1, window, final_relu, tiles,
                             knockout=0) -> torch.Tensor:
    """Launch ``csrc/gin_local_layer_blocks.cu`` for the wrapper ``counted``:
    ``u_local`` / ``v_local`` may be strided columns (int32, ``stride``
    elements apart); ``block_window`` None means ``blocks`` equal windows'
    worth of lanes in window order; ``tiles`` the bf16 MLP's chunks of this
    layer, or None to pack them here (once per weight set)."""
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    p = ee.shape[0]
    hid = check_gin_mlp(h, m_spill, w1, b1, w2, b2, eps1)
    _check("ee", ee, dt, (p, d), dev)
    if blocks < 1 or p % blocks:
        raise ValueError(f"ee: {p} lanes are not {blocks} equal blocks")
    for name, x in (("u_local", u_local), ("v_local", v_local)):
        if x.dtype != torch.int32 or x.device != dev or tuple(x.shape) != (p,):
            raise ValueError(f"{name}: the kernel takes int32 [{p}] on {dev}")
    stride = u_local.stride(0)
    if v_local.stride(0) != stride:
        raise ValueError("u_local and v_local: different strides")
    if block_window is not None:
        _check("block_window", block_window, torch.int32, (blocks,), dev)
    _check_pairs(("ee", ee), ("h", h), ("m_spill", m_spill))
    name = "gin_local_layer_blocks"
    lib = _library(name)
    stages, _ = _gin_layer_plan(name, code, d, hid, 0, window, dev.index)
    if code == 1:  # the wgmma MLP reads the layer's weights as packed chunks
        tiles = _mlp_operand(None, tiles, w1, w2, 1, per_layer=True)
    nw = -(-n // window)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ee.data_ptr(), u_local.data_ptr(), v_local.data_ptr(),
        None if block_window is None else block_window.data_ptr(), h.data_ptr(),
        None if m_spill is None else m_spill.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), eps1.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(), nw, n, window, blocks,
        p // blocks, stride, d, hid, int(bool(final_relu)), stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, counted.__name__)
    counted.launches += 1
    counted.stages = stages
    return out


def _launch_gin_local_layer(ee, u_local, v_local, block_window, h, m_spill, w1, b1, w2, b2,
                            eps1, window, final_relu, tiles, knockout=0) -> torch.Tensor:
    return _launch_gin_layer_blocks(gin_local_layer, ee, u_local, v_local, block_window,
                                    block_window.shape[0], h, m_spill, w1, b1, w2, b2, eps1,
                                    window, final_relu, tiles, knockout)


def gin_local_layer(
    ee: torch.Tensor,
    u_local: torch.Tensor,
    v_local: torch.Tensor,
    block_window: torch.Tensor,
    h: torch.Tensor,
    m_spill: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps1: torch.Tensor,
    window: int,
    final_relu: bool,
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole GIN / GIN-VN layer over the legacy dynamic-window local
    layout: the next h [n, D] in h's dtype (``csrc/gin_local_layer_blocks.cu``).
    Operands as in ``gin_local_layer_ref``; a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (float32 or bfloat16 ``ee``,
    h, ``m_spill`` and weights, int32 lanes and ``block_window``, float32
    ``eps1``) or raises. In bfloat16 the update MLP runs on the tensor cores
    from ``mlp_tiles``, as in ``gin_local_layer_ell`` (``.stages`` the
    weight ring). ``knockout`` as there. Each launch adds one to
    ``gin_local_layer.launches``."""
    args = (ee, u_local, v_local, block_window, h, m_spill, w1, b1, w2, b2, eps1, window,
            final_relu, mlp_tiles)
    if _knocked_out(h, knockout):
        return _launch_gin_local_layer(*args, knockout=knockout)
    return _dispatch(h, gin_local_layer_ref, _launch_gin_local_layer, args)


gin_local_layer.launches = 0
gin_local_layer.stages = 0


def _launch_gin_layer_ell_lanes(ee, ell_meta, h, m_spill, w1, b1, w2, b2, eps1, window,
                                final_relu, tiles, knockout=0) -> torch.Tensor:
    nw = -(-h.shape[0] // window)
    _ell_block(ell_meta, nw, h.device)
    return _launch_gin_layer_blocks(gin_local_layer_ell_lanes, ee, ell_meta[:, 0], ell_meta[:, 1],
                                    None, nw, h, m_spill, w1, b1, w2, b2, eps1, window,
                                    final_relu, tiles, knockout)


def gin_local_layer_ell_lanes(
    ee: torch.Tensor,
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    m_spill: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps1: torch.Tensor,
    window: int,
    final_relu: bool,
    mlp_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole GIN / GIN-VN layer over the ELL layout with each lane's
    bond embedding given: the next h [n, D] in h's dtype (the kernel of
    ``csrc/gin_local_layer_blocks.cu`` on its static grid). Operands as in
    ``gin_local_layer_ell_lanes_ref``; a CPU tensor runs the plain version,
    a CUDA tensor launches the kernel or raises. ``mlp_tiles`` and
    ``knockout`` as in ``gin_local_layer``. Each launch adds one to
    ``gin_local_layer_ell_lanes.launches``."""
    args = (ee, ell_meta, h, m_spill, w1, b1, w2, b2, eps1, window, final_relu, mlp_tiles)
    if _knocked_out(h, knockout):
        return _launch_gin_layer_ell_lanes(*args, knockout=knockout)
    return _dispatch(h, gin_local_layer_ell_lanes_ref, _launch_gin_layer_ell_lanes, args)


gin_local_layer_ell_lanes.launches = 0
gin_local_layer_ell_lanes.stages = 0


def _launch_gin_message_ell(ell_meta, ee_table, h, window) -> torch.Tensor:
    code = _dtype_code(h.dtype)
    dev = h.device
    n, d = h.shape
    _check("h", h, h.dtype, (n, d), dev)
    vocab = ee_table.shape[0]
    _check("ee_table", ee_table, h.dtype, (vocab, d), dev)
    _check_pairs(("h", h))
    name = "gin_local_message_ell"
    lib = _library(name)
    _layer_plan(name, code, d, 0, window, dev.index, vocab)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, d), dtype=h.dtype, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), ee_table.data_ptr(), out.data_ptr(), nw, n,
        window, lanes, d, vocab, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, name)
    gin_local_message_ell.launches += 1
    return out


def gin_local_message_ell(
    ell_meta: torch.Tensor,
    ee_table: torch.Tensor,
    h: torch.Tensor,
    window: int,
) -> torch.Tensor:
    """GIN's message sum over the ELL layout, the bond embedding summed from
    the layer's table in the kernel: [n, D] in h's dtype
    (``csrc/gin_local_message_ell.cu``: the messages-only form of row 13's
    kernel, W of 128 to 1024 rows, any k edge blocks a window, any D from 1
    to 128). The JAX function's ``edge_attr``, ``u_local`` and ``v_local`` are
    ``ell_meta``'s columns; its ``k_blocks`` is ``ell_meta``'s lanes a window
    and its ``wps`` is not carried over, as in ``gin_local_layer_ell``.
    Operands as in ``gin_local_message_ell_ref``; a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (float32 or bfloat16 h and
    table, int32 ``ell_meta``; its plan from ``_layer_plan``) or raises.
    Each launch adds one to ``gin_local_message_ell.launches``."""
    return _dispatch(h, gin_local_message_ell_ref, _launch_gin_message_ell,
                     (ell_meta, ee_table, h, window))


gin_local_message_ell.launches = 0


def _launch_gin_message_ell_lanes(ee, ell_meta, h, m_spill, window) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    _check("h", h, dt, (n, d), dev)
    if m_spill is not None:
        _check("m_spill", m_spill, dt, (n, d), dev)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    _check("ee", ee, dt, (ell_meta.shape[0], d), dev)
    _check_pairs(("ee", ee), ("h", h), ("m_spill", m_spill))
    name = "gin_local_message_lanes"
    lib = _library(name)
    _layer_plan(name, code, d, 0, window, dev.index)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ee.data_ptr(), ell_meta[:, 0].data_ptr(), ell_meta[:, 1].data_ptr(), h.data_ptr(),
        None if m_spill is None else m_spill.data_ptr(), out.data_ptr(), nw, n, window, lanes,
        ell_meta.stride(0), d, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gin_local_message_ell_lanes")
    gin_local_message_ell_lanes.launches += 1
    return out


def gin_local_message_ell_lanes(
    ee: torch.Tensor,
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    m_spill: Optional[torch.Tensor],
    window: int,
) -> torch.Tensor:
    """GIN's message sum over the ELL layout with each lane's bond embedding
    given, plus ``m_spill``: [n, D] in h's dtype
    (``csrc/gin_local_message_lanes.cu``: the messages-only form of rows 10
    / 12's kernel on the static ELL grid, W of 128 to 1024 rows, any D from 1
    to 128), the JAX ``local_scatter_apply_ell`` with the ELL stage bench's
    pass-through epilogue. Operands as in ``gin_local_message_ell_lanes_ref``
    (row 12's, as ``gin_local_layer_ell_lanes`` takes them, without the
    MLP); a CPU tensor runs the plain version, a CUDA tensor launches the
    kernel (float32 or bfloat16 ``ee``, h and ``m_spill``, int32
    ``ell_meta``) or raises. Each launch adds one to
    ``gin_local_message_ell_lanes.launches``."""
    return _dispatch(h, gin_local_message_ell_lanes_ref, _launch_gin_message_ell_lanes,
                     (ee, ell_meta, h, m_spill, window))


gin_local_message_ell_lanes.launches = 0


def _launch_gcn_message_ell(ell_meta, h, dis, ee_table, window, knockout=0) -> torch.Tensor:
    code = _dtype_code(h.dtype)
    dev = h.device
    n, d = h.shape
    _check("h", h, h.dtype, (n, d), dev)
    _check("dis", dis, h.dtype, (n,), dev)
    vocab = ee_table.shape[0]
    _check("ee_table", ee_table, h.dtype, (vocab, d), dev)
    name = "gcn_local_message_ell"
    lib = _library(name)
    _layer_plan(name, code, d, 0, window, dev.index, vocab)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, d), dtype=h.dtype, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), dis.data_ptr(), ee_table.data_ptr(),
        out.data_ptr(), nw, n, window, lanes, d, vocab, int(knockout),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, name)
    gcn_local_message_ell.launches += 1
    return out


def gcn_local_message_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    dis: torch.Tensor,
    ee_table: torch.Tensor,
    window: int,
    knockout: int = 0,
) -> torch.Tensor:
    """GCN's message sum over the ELL layout: [n, D] in h's dtype
    (``csrc/gcn_local_message_ell.cu``: the messages-only form of row 9's
    cluster kernel, a cluster of W/128 blocks per window of 128 to 1024
    rows, any k edge blocks a window, any D from 1 to 128). Operands as in
    ``gcn_local_message_ell_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h, dis and table,
    int32 ``ell_meta``; its plan from ``_layer_plan``) or raises.
    ``knockout`` (timing only, CUDA only): bit 1 skips the messages (zeros
    are written). Each launch adds one to ``gcn_local_message_ell.launches``."""
    args = (ell_meta, h, dis, ee_table, window)
    if _knocked_out(h, knockout):
        return _launch_gcn_message_ell(*args, knockout=knockout)
    return _dispatch(h, gcn_local_message_ell_ref, _launch_gcn_message_ell, args)


gcn_local_message_ell.launches = 0


def _launch_gcn_layer_ell(ell_meta, h, dis, ee_table, root, alpha, beta, w_next, b_next,
                          window, tiles, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    _check("h", h, dt, (n, d), dev)
    _check("dis", dis, dt, (n,), dev)
    vocab = ee_table.shape[0]
    _check("ee_table", ee_table, dt, (vocab, d), dev)
    for name, x in (("root", root), ("alpha", alpha), ("beta", beta)):
        _check(name, x, dt, (d,), dev)
    if (w_next is None) != (b_next is None):
        raise ValueError("w_next and b_next: both or neither")
    if w_next is not None:
        _check("w_next", w_next, dt, (d, d), dev)
        _check("b_next", b_next, dt, (d,), dev)
    name = "gcn_local_layer_ell"
    lib = _library(name)
    stages, _ = _layer_plan(name, code, d, 0, window, dev.index, vocab)
    conv = code == 1 and w_next is not None
    if conv:  # the wgmma next conv reads the layer's weights as packed chunks
        tiles = _layer_tiles(name, d, tiles, lambda: gcn_layer_tiles(w_next), dev)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), dis.data_ptr(), ee_table.data_ptr(),
        root.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
        None if w_next is None else w_next.data_ptr(),
        None if b_next is None else b_next.data_ptr(), tiles.data_ptr() if conv else None,
        out.data_ptr(), nw, n, window, lanes, d, vocab, stages, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gcn_local_layer_ell")
    gcn_local_layer_ell.launches += 1
    gcn_local_layer_ell.stages = stages
    return out


def gcn_local_layer_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    dis: torch.Tensor,
    ee_table: torch.Tensor,
    root: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    w_next: Optional[torch.Tensor],
    b_next: Optional[torch.Tensor],
    window: int,
    conv_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole GCN layer over an ELL batch with no spill tail after its
    conv: the next conv's output, or on the last layer (``w_next`` None) the
    pre-pool tail, [n, D] in h's dtype (``csrc/gcn_local_layer_ell.cu``: the
    one-layer form of row 9's cluster kernel, a cluster of W/128 blocks per
    window of 128 to 1024 rows, any k edge blocks a window). Operands as in
    ``gcn_local_layer_ell_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 h, dis, table, root /
    alpha / beta and weights, int32 ``ell_meta``; an even D at most 112) or
    raises. In bfloat16 the next conv runs on the tensor cores (``wgmma``)
    from ``conv_tiles``, this layer's [C, 32·N] chunks of ``gcn_conv_tiles``
    (row 9's; packed here by ``gcn_layer_tiles``, once per weight set, when
    not given); ``gcn_local_layer_ell.stages`` records the launch's weight
    ring (0 in float32). ``knockout`` (timing only, CUDA only): bit 0 skips
    the next conv, bit 1 the messages. Each launch adds one to
    ``gcn_local_layer_ell.launches``."""
    args = (ell_meta, h, dis, ee_table, root, alpha, beta, w_next, b_next, window, conv_tiles)
    if _knocked_out(h, knockout):
        return _launch_gcn_layer_ell(*args, knockout=knockout)
    return _dispatch(h, gcn_local_layer_ell_ref, _launch_gcn_layer_ell, args)


gcn_local_layer_ell.launches = 0
gcn_local_layer_ell.stages = 0


def _launch_dgn_layer_ell(ell_meta, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post,
                          window, tiles, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    _check("h", h, dt, (n, d), dev)
    for name, x in (("eig", eig), ("inv_deg", inv_deg), ("eigw_sum", eigw_sum),
                    ("inv_abssum", inv_abssum)):
        _check(name, x, dt, (n,), dev)
    _check("w_post", w_post, dt, (2 * d, d), dev)
    _check("b_post", b_post, dt, (1, d), dev)
    name = "dgn_local_layer_ell_model"
    lib = _library(name)
    stages, _ = _layer_plan(name, code, d, 0, window, dev.index)
    if code == 1:  # the wgmma posttrans reads the layer's weights as packed chunks
        tiles = _layer_tiles(name, d, tiles, lambda: dgn_layer_tiles(w_post), dev)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), eig.data_ptr(), inv_deg.data_ptr(),
        eigw_sum.data_ptr(), inv_abssum.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
        None if code == 0 else tiles.data_ptr(), out.data_ptr(), nw, n, window, lanes, d, stages,
        int(knockout), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_layer_ell")
    dgn_local_layer_ell.launches += 1
    dgn_local_layer_ell.stages = stages
    return out


def dgn_local_layer_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    eig: torch.Tensor,
    inv_deg: torch.Tensor,
    eigw_sum: torch.Tensor,
    inv_abssum: torch.Tensor,
    w_post: torch.Tensor,
    b_post: torch.Tensor,
    window: int,
    posttrans_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole DGN layer over an ELL batch with no spill tail: the next h
    [n, D] in h's dtype (``csrc/dgn_local_layer_ell_model.cu``: the one-layer form
    of row 4's cluster kernel with the ELL lane walk, a cluster of W/128
    blocks per window of 128 to 1024 rows, any k edge blocks a window).
    Operands as in ``dgn_local_layer_ell_ref``; a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (float32 or bfloat16 h, node
    terms and weights, int32 ``ell_meta``; D at most 112) or raises. In
    bfloat16 the posttrans runs on the tensor cores (``wgmma``) from
    ``posttrans_tiles``, this layer's [C, 32·N] chunks of
    ``dgn_posttrans_tiles`` (row 22's; packed here by ``dgn_layer_tiles``,
    once per weight set, when not given); ``dgn_local_layer_ell.stages``
    records the launch's weight ring (0 in float32). ``knockout`` (timing
    only, CUDA only): bit 0 skips the posttrans product, bit 1 the channels.
    Each launch adds one to ``dgn_local_layer_ell.launches``."""
    args = (ell_meta, h, eig, inv_deg, eigw_sum, inv_abssum, w_post, b_post, window,
            posttrans_tiles)
    if _knocked_out(h, knockout):
        return _launch_dgn_layer_ell(*args, knockout=knockout)
    return _dispatch(h, dgn_local_layer_ell_ref, _launch_dgn_layer_ell, args)


dgn_local_layer_ell.launches = 0
dgn_local_layer_ell.stages = 0


def _launch_dgn_message_ell(ell_meta, h, eig, window, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, d = h.shape
    _check("h", h, dt, (n, d), dev)
    _check("eig", eig, dt, (n,), dev)
    name = "dgn_local_layer_ell"
    lib = _library(name)
    _layer_plan(name, code, d, 0, window, dev.index)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, 2 * d), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), eig.data_ptr(), out.data_ptr(), nw, n, window,
        lanes, d, int(knockout), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "dgn_local_message_ell")
    dgn_local_message_ell.launches += 1
    return out


def dgn_local_message_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    eig: torch.Tensor,
    window: int,
    knockout: int = 0,
) -> torch.Tensor:
    """DGN's two message channels over the ELL layout: [n, 2D] [m1 ‖ m2] in
    h's dtype (``csrc/dgn_local_layer_ell.cu``: the channels-only form of
    row 4's cluster kernel, a cluster of W/128 blocks per window of 128 to
    1024 rows, any k edge blocks a window, any D from 1 to 128), for the
    caller to merge a spill tail. Operands as in
    ``dgn_local_message_ell_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h and eig, int32
    ``ell_meta``; its plan from ``_layer_plan``) or raises. ``knockout``
    (timing only, CUDA only): bit 1 skips the channels (zeros are written).
    Each launch adds one to ``dgn_local_message_ell.launches``."""
    args = (ell_meta, h, eig, window)
    if _knocked_out(h, knockout):
        return _launch_dgn_message_ell(*args, knockout=knockout)
    return _dispatch(h, dgn_local_message_ell_ref, _launch_dgn_message_ell, args)


dgn_local_message_ell.launches = 0


def _launch_gat_message_ell(ell_meta, h, s_src, s_tgt, window, num_heads,
                            knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, hd = h.shape
    if hd % num_heads:
        raise ValueError(f"H·D={hd} is not a multiple of the {num_heads} heads")
    _check("s_src", s_src, dt, (n, num_heads), dev)
    _check("s_tgt", s_tgt, dt, (n, num_heads), dev)
    lib, lanes, nw = _check_ell_lanes(ell_meta, h, window, "gat_local_message_ell",
                                      (hd, num_heads))
    if not 1 <= num_heads <= lib["max_heads"]():
        raise ValueError(f"num_heads={num_heads} outside 1..{lib['max_heads']()}")
    out = torch.empty((n, hd + num_heads), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), s_src.data_ptr(), s_tgt.data_ptr(),
        out.data_ptr(), nw, n, window, lanes, hd, num_heads, int(knockout), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "gat_local_message_ell")
    gat_local_message_ell.launches += 1
    return out


def gat_local_message_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    s_src: torch.Tensor,
    s_tgt: torch.Tensor,
    window: int,
    num_heads: int,
    knockout: int = 0,
) -> torch.Tensor:
    """GAT's edge-softmax sums of one layer over the ELL layout: [n, H·D +
    H] [Σ score·h_u ‖ Σ score] in h's dtype (``csrc/gat_local_message_ell.cu``,
    row 23's message walk, ``csrc/gat_messages.cuh``), for the caller to
    merge a spill tail and divide. Operands as in
    ``gat_local_message_ell_ref``; a CPU tensor runs the plain version, a
    CUDA tensor launches the kernel (float32 or bfloat16 h and scores, int32
    ``ell_meta``; H·D at most 128, at most 32 heads) or raises.
    ``knockout`` (timing only, CUDA only): bit 1 skips the messages. Each
    launch adds one to ``gat_local_message_ell.launches``."""
    args = (ell_meta, h, s_src, s_tgt, window, num_heads)
    if _knocked_out(h, knockout):
        return _launch_gat_message_ell(*args, knockout=knockout)
    return _dispatch(h, gat_local_message_ell_ref, _launch_gat_message_ell, args)


gat_local_message_ell.launches = 0


@functools.cache
def _gat_layer_plan(code: int, hd: int, heads: int, window: int, device: int) -> tuple:
    """Row 23's launch plan at this geometry on CUDA device ``device``,
    worked out once per geometry: (the bf16 weight ring, the deepest that
    keeps two blocks an SM, 0 in f32; the block's shared memory). Raises
    before launch on what the window, the tile, the heads or the card's
    shared memory do not take, or a chunk geometry the host does not share;
    a refusal is not cached."""
    name = "gat_local_layer_ell"
    lib = _library(name)
    dev = torch.device("cuda", device)
    _check_tile(lib, hd)
    if not 1 <= heads <= lib["max_heads"]():
        raise ValueError(f"num_heads={heads} outside 1..{lib['max_heads']()}")
    smem_of = lambda stages: lib["smem_bytes"](code, hd, heads, stages)
    stages = 0
    if code == 1:  # the wgmma products stream their chunks through a ring
        kp, skip_c, proj_c, elems = gat_layer_geometry(hd)
        dims = (ctypes.c_int * 4)()
        lib["tile_dims"](hd, dims)
        if tuple(dims) != (kp, skip_c, proj_c, elems * 2):
            raise RuntimeError(f"the kernel's chunk geometry {tuple(dims)} is not the host's "
                               f"{(kp, skip_c, proj_c, elems * 2)}")
        stages = ring_stages(smem_of, skip_c + proj_c, _two_blocks_budget(lib, dev))
    smem = smem_of(stages)
    _check_ell_geometry(lib, hd, window, smem, dev)
    _prepare(name, lib, smem, device)
    return stages, smem


def _gat_layer_operand(tiles, w_skip: torch.Tensor, w_proj: torch.Tensor) -> torch.Tensor:
    """Row 23's packed weights of one layer: ``tiles`` as given, or packed
    here once per weight set (``gat_layer_tiles``), checked."""
    hd = w_skip.shape[0]
    if tiles is None:
        tiles = gat_layer_tiles(w_skip[None], w_proj[None])[0]
    if w_skip.dtype == torch.bfloat16:
        _, skip_c, proj_c, elems = gat_layer_geometry(hd)
        _check("layer_tiles", tiles, torch.bfloat16, (skip_c + proj_c, elems), w_skip.device)
    else:
        _check("layer_tiles", tiles, w_skip.dtype, (2, hd, GAT_LAYER_N), w_skip.device)
    return tiles


def _launch_gat_layer_ell(ell_meta, h, s_src, s_tgt, prev, spill_both, w_skip, w_proj, a_mat,
                          window, num_heads, tiles, knockout=0) -> torch.Tensor:
    dt = h.dtype
    code = _dtype_code(dt)
    dev = h.device
    n, hd = h.shape
    if hd % num_heads:
        raise ValueError(f"H·D={hd} is not a multiple of the {num_heads} heads")
    _check("h", h, dt, (n, hd), dev)
    _check("s_src", s_src, dt, (n, num_heads), dev)
    _check("s_tgt", s_tgt, dt, (n, num_heads), dev)
    _check("prev", prev, dt, (n, hd), dev)
    if spill_both is not None:
        _check("spill_both", spill_both, dt, (n, hd + num_heads), dev)
    _check("w_skip", w_skip, dt, (hd, hd), dev)
    _check("w_proj", w_proj, dt, (hd, hd), dev)
    _check("a_mat", a_mat, dt, (hd, 2 * num_heads), dev)
    if prev.data_ptr() % 16:
        raise ValueError("prev: its rows are copied 16 bytes at a time; its data must be "
                         "16-byte aligned")
    name = "gat_local_layer_ell"
    lib = _library(name)
    stages, _ = _gat_layer_plan(code, hd, num_heads, window, dev.index)
    tiles = _gat_layer_operand(tiles, w_skip, w_proj)
    nw = -(-n // window)
    lanes = _ell_block(ell_meta, nw, dev)
    out = torch.empty((n, 2 * hd + 2 * num_heads), dtype=dt, device=dev)
    rc = lib["launch"](
        code, ell_meta.data_ptr(), h.data_ptr(), s_src.data_ptr(), s_tgt.data_ptr(),
        prev.data_ptr(), None if spill_both is None else spill_both.data_ptr(),
        a_mat.data_ptr(), tiles.data_ptr(), out.data_ptr(),
        nw, n, window, lanes, hd, num_heads, stages, int(knockout),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, name)
    gat_local_layer_ell.launches += 1
    gat_local_layer_ell.stages = stages
    return out


def gat_local_layer_ell(
    ell_meta: torch.Tensor,
    h: torch.Tensor,
    s_src: torch.Tensor,
    s_tgt: torch.Tensor,
    prev: torch.Tensor,
    spill_both: Optional[torch.Tensor],
    w_skip: torch.Tensor,
    w_proj: torch.Tensor,
    a_mat: torch.Tensor,
    window: int,
    num_heads: int,
    layer_tiles: Optional[torch.Tensor] = None,
    knockout: int = 0,
) -> torch.Tensor:
    """One whole non-final GAT layer over the ELL layout: [n, 2·H·D + 2H]
    (h_next ‖ feat ‖ s_src' ‖ s_tgt') in h's dtype
    (``csrc/gat_local_layer_ell.cu``). Operands as in
    ``gat_local_layer_ell_ref``; a CPU tensor runs the plain version, a CUDA
    tensor launches the kernel (float32 or bfloat16 h, scores, ``prev``,
    ``spill_both`` and weights, int32 ``ell_meta``) or raises. The kernel
    reads w_skip and w_proj from ``layer_tiles``, this layer's slice of
    ``gat_layer_tiles()`` (packed here, once per weight set, when not
    given); in bfloat16 both products run on the tensor cores, their chunks
    through a weight ring as deep as two blocks an SM allow
    (``gat_local_layer_ell.stages``; 0 in float32). ``knockout`` times the
    CUDA kernel without a stage (bit 0 both products, bit 1 the messages;
    the models never set it). Each launch adds one to
    ``gat_local_layer_ell.launches``."""
    args = (ell_meta, h, s_src, s_tgt, prev, spill_both, w_skip, w_proj, a_mat, window,
            num_heads, layer_tiles)
    if _knocked_out(h, knockout):
        return _launch_gat_layer_ell(*args, knockout=knockout)
    return _dispatch(h, gat_local_layer_ell_ref, _launch_gat_layer_ell, args)


gat_local_layer_ell.launches = 0
gat_local_layer_ell.stages = 0
