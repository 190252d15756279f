"""Kernel table rows 16 and 19, the channels-only form of ``csrc/dgn_model.cuh``
and the stats-only form of ``csrc/pna_model.cuh``, on the host: a plain
mirror of each CUDA kernel's algorithm (a cluster of W/128 blocks per window,
each staging its 128 rows; sources read from the block that owns them; row
16's lanes 16 at a time in lane order, row 19's slots packed by one ballot)
against the plain version and the Pallas kernel in interpret mode, f32 to
1e-5 of the output's scale, at W = 128 and 1024 (row 19 also 384), with the
lanes and slots that add nothing; and ``bench.slot_kernels`` timing row 19
on the launches PNA's spill path makes."""

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from test_torch_cuda import _port, _row16_operands, _row19_operands
from test_torch_local_layer import _jax_kernel

ROWS = 128  # window rows a block of the cluster owns
GROUP = 16  # row 16's lanes loaded at a time: a half-warp's threads


def _staged(x: torch.Tensor, r0: int, n: int, stride: int) -> torch.Tensor:
    """A block's 128 rows of ``x`` from row r0 as its shared memory holds them:
    f32, ``stride`` columns (an odd width's pad column zero), padding rows
    (at or past n) zero."""
    out = torch.zeros(ROWS, stride, dtype=torch.float32)
    rows = max(0, min(ROWS, n - r0))
    out[:rows, : x.shape[1]] = x[r0 : r0 + rows].float()
    return out


def _row16_mirror(ell_meta, h, eig, window):
    """Row 16's CUDA algorithm (``dgn_model.cuh``: ``dgn_channels_kernel``) in
    plain torch. Per window, each of its W/128 blocks stages its 128 rows of
    h (at an even stride) and of eig; row r's lanes are [the first lane whose
    v is at least r, the first whose v is at least r + 1) over the window's
    lanes (``lanes::ell_runs``' marks); a row's lanes go 16 at a time in lane
    order, each read from the block that owns u; a lane whose u lies outside
    [0, W) or on a padding row adds nothing; f32 sums of [h_u | rnd(e_u·h_u)]
    (rounded to h's dtype), then m2 = acc₂ − e_v·m1; [m1 | m2] in h's dtype."""
    n, d = h.shape
    nw = -(-n // window)
    lanes = ell_meta.shape[0] // nw
    stride = d + d % 2
    blocks = window // ROWS
    rnd = lambda x: x.to(h.dtype).float()
    meta = ell_meta.long().reshape(nw, lanes, 5)
    out = torch.zeros(nw * window, 2 * d, dtype=torch.float32)
    for w in range(nw):
        wrow0 = w * window
        hs = torch.stack([_staged(h, wrow0 + b * ROWS, n, stride) for b in range(blocks)])
        es = torch.stack([_staged(eig[:, None], wrow0 + b * ROWS, n, 1)[:, 0]
                          for b in range(blocks)])
        u, v = meta[w, :, 0], meta[w, :, 1].contiguous()
        for b in range(blocks):
            lo = torch.searchsorted(v, b * ROWS + torch.arange(ROWS + 1))
            count = lo[1:] - lo[:-1]
            m1 = torch.zeros(ROWS, stride)
            acc2 = torch.zeros(ROWS, stride)
            for e0 in range(0, int(count.max()), GROUP):
                for k in range(GROUP):  # the group's lanes, handed round in order
                    e = (lo[:-1] + e0 + k).clamp(max=lanes - 1)
                    uu = u[e]
                    ok = (e0 + k < count) & (uu >= 0) & (uu < window) & (wrow0 + uu < n)
                    src = uu.clamp(0, window - 1)
                    x = hs[src // ROWS, src % ROWS]
                    eu = es[src // ROWS, src % ROWS]
                    m1 = torch.where(ok[:, None], m1 + x, m1)
                    acc2 = torch.where(ok[:, None], acc2 + rnd(eu[:, None] * x), acc2)
            m2 = acc2 - es[b][:, None] * m1
            out[wrow0 + b * ROWS : wrow0 + (b + 1) * ROWS] = torch.cat([m1[:, :d], m2[:, :d]], 1)
    return out[:n].to(h.dtype)


def _row19_mirror(slot_src, h, window, slots, min_init, max_init):
    """Row 19's CUDA algorithm (``pna_model.cuh``: ``pna_stats_kernel``) in
    plain torch. Per window, each of its W/128 blocks stages its 128 rows of
    h (at an even stride; a padding row reads zeros) and of slot_src; a row's
    thread t < S loads slot t, one ballot keeps the valid ones (not the
    sentinel W) packed in slot order, and the row's f32 s, q, mn, mx (seeded
    at 0, 0, min_init, max_init) update over them in that order, each source
    read from the block that owns it; [s | q | mn | mx] in h's dtype."""
    n, d = h.shape
    nw = -(-n // window)
    stride = d + d % 2
    blocks = window // ROWS
    out = torch.zeros(nw * window, 4 * d, dtype=torch.float32)
    for w in range(nw):
        wrow0 = w * window
        hs = torch.stack([_staged(h, wrow0 + b * ROWS, n, stride) for b in range(blocks)])
        for b in range(blocks):
            r0 = wrow0 + b * ROWS
            src = slot_src[r0 : r0 + ROWS].long()
            valid = (src >= 0) & (src < window)
            packed = torch.gather(src, 1, torch.argsort((~valid).int(), dim=1, stable=True))
            count = valid.sum(1)
            s, q = torch.zeros(ROWS, stride), torch.zeros(ROWS, stride)
            mn, mx = torch.full((ROWS, stride), min_init), torch.full((ROWS, stride), max_init)
            for k in range(slots):
                ok = (k < count)[:, None]
                u = packed[:, k].clamp(0, window - 1)
                x = hs[u // ROWS, u % ROWS]
                s = torch.where(ok, s + x, s)
                q = torch.where(ok, q + x * x, q)
                mn = torch.where(ok, torch.minimum(mn, x), mn)
                mx = torch.where(ok, torch.maximum(mx, x), mx)
            out[r0 : r0 + ROWS] = torch.cat([t[:, :d] for t in (s, q, mn, mx)], 1)
    return out[:n].to(h.dtype)


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = torch.as_tensor(np.array(want))
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("window,k", [(128, 1), (128, 2), (1024, 1), (1024, 2)])
def test_row16_mirror_matches_plain_and_jax(window, k, monkeypatch):
    """Row 16's algorithm on the card equals the plain version (f32 to 1e-6
    of the output's scale: the same lane order) and the Pallas kernel in
    interpret mode (1e-5) at D = 5 (odd: a padded row stride), with a real
    lane's u outside [0, W) in every window, pad lanes given a live source,
    and lanes from and to padding rows (``_turned_lanes``); the large graph's
    sources lie in other blocks of the window's cluster."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _row16_operands(window, k, 5)
    port = _port(ops, "cpu")
    got = _row16_mirror(**port)
    u, v = port["ell_meta"][:, 0], port["ell_meta"][:, 1]
    real = (u >= 0) & (u < window) & (v < window)
    assert bool((real & (u // ROWS != v // ROWS)).any()) == (window > ROWS)  # across blocks
    assert bool(((u < 0) | (u >= window)).any())
    _close(got, local_layer.dgn_local_message_ell_ref(**port), 1e-6)
    jax_ops = dict(u_local=ops["ell_meta"][:, 0].copy(), v_local=ops["ell_meta"][:, 1].copy(),
                   h=ops["h"], eig=ops["eig"], window=window, k_blocks=k)
    _close(got, np.concatenate(list(_jax_kernel("dgn_local_message_ell", jax_ops)), 1), 1e-5)


@pytest.mark.parametrize("window,slots", [(128, 1), (128, 8), (384, 8), (1024, 3)])
def test_row19_mirror_matches_plain_and_jax(window, slots, monkeypatch):
    """Row 19's algorithm on the card equals the plain version (f32 to 1e-6
    of the output's scale: the same slot order) and the Pallas kernel in
    interpret mode (1e-5) at D = 5, with sentinel slots (a quarter), sources
    anywhere in the window (in other blocks of its cluster, on padding rows)
    and rows with no source, which keep the seeds exactly."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _row19_operands(window, 5, slots)
    port = _port(ops, "cpu")
    got = _row19_mirror(**port)
    src = port["slot_src"].long()
    assert bool((src == window).any()) and bool(((src >= ops["h"].shape[0] % window) &
                                                 (src < window)).any())
    seeds = torch.tensor([0.0] * 5 + [0.0] * 5 + [ops["min_init"]] * 5 + [ops["max_init"]] * 5)
    assert torch.equal(got[::11], seeds.expand(got[::11].shape[0], -1))
    _close(got, local_layer.pna_local_stats_ell_ref(**port), 1e-6)
    _close(got, _jax_kernel("pna_local_stats_ell", ops), 1e-5)


def test_slot_kernels_tool_times_row19_on_the_spill_path():
    """``bench.slot_kernels`` times row 19 (``pna_local_stats_ell``) on the
    launches PNA's spill path makes: the hep10k sample in slots at W=128,
    every bucket spilling, each bucket's layer-0 stats operands once per
    layer; the operands are the ones the path hands the wrapper, and its
    plain version takes them."""
    from flowgnn_tpu_torch.bench import slot_kernels
    from flowgnn_tpu_torch.models import pna

    cell = ("pna_local_stats_ell", "pna", "hep10k", 2048, slot_kernels.SLOTS, 128)
    assert cell in slot_kernels.CELLS and cell[0] in slot_kernels.LAYER_KERNELS
    batches = slot_kernels.stream("pna", "hep10k", 60, slot_kernels.SLOTS, 128, "cpu")
    assert batches and all(bool(b["slot_spill_mask"].any()) for b in batches)
    ops = slot_kernels.calls(cell[0], "pna", batches, slot_kernels.SLOTS, tn.FLOAT32, "cpu")
    assert len(ops) == tr.get("pna").num_layers * len(batches)
    params = slot_kernels.params_of("pna", tn.FLOAT32, "cpu")
    path = pna.layer_kernel_operands(params, batches[-1], tn.FLOAT32)
    assert set(ops[-1]) == set(path[cell[0]])
    assert all(torch.equal(ops[-1][k], v) if torch.is_tensor(v) else ops[-1][k] == v
               for k, v in path[cell[0]].items())
    out = local_layer.pna_local_stats_ell_ref(**ops[-1])
    assert out.shape == (ops[-1]["h"].shape[0], 4 * ops[-1]["h"].shape[1])
    assert bool(out.isfinite().all())
