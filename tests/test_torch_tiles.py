"""The host packing of ``wgmma`` operands (``flowgnn_tpu_torch.ops.tiles``)
and its two users: row 26's B (``bench.matmul_shapes``) and row 8's bf16
weight tiles (``ops.local_layer.gin_mlp_tiles``).

Besides the round trip and the zero pad, each packed tile is read back the
way the kernels' shared-memory descriptors address it (``csrc/hopper.cuh``:
element (row r, byte kb of K) at start + (kb // 16)·LBO + (r // 8)·SBO +
(r % 8)·16 + kb % 16), at the offsets and strides the kernels compute.
"""

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.ops.tiles import kmajor_tiles

DTYPES = [torch.bfloat16, torch.int8, torch.float32]


def _draw(shape, dtype, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)


def kmajor_untile(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The [..., rows, cols] matrix that ``kmajor_tiles`` packed into ``t``,
    its padding dropped."""
    *lead, groups, r, per = t.shape
    return t.transpose(-3, -2).reshape(*lead, r, groups * per)[..., :rows, :cols]


def _read(tiles: torch.Tensor, start: int, lbo: int, sbo: int, rows: int, kbytes: int):
    """The [rows, kbytes / es] operand a descriptor at byte ``start`` with
    offsets ``lbo`` / ``sbo`` reads from ``tiles`` (one 64-row or N-row
    wgmma operand and ``kbytes`` of K)."""
    es = tiles.element_size()
    flat = tiles.contiguous().view(-1).view(torch.uint8)
    r = torch.arange(rows)[:, None]
    kb = torch.arange(0, kbytes, es)[None, :]
    at = start + (kb // 16) * lbo + (r // 8) * sbo + (r % 8) * 16 + kb % 16
    idx = at[..., None] + torch.arange(es)
    return flat[idx.reshape(-1)].view(tiles.dtype).view(rows, kbytes // es)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,rows,cols", [((200, 100), 224, 112), ((3, 40, 64), 40, 64),
                                             ((136, 64), 256, 64), ((7, 9), 8, 16)])
def test_kmajor_tiles_round_trip_and_zero_pad(dtype, shape, rows, cols):
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    cols = -(-cols // per) * per
    w = _draw(shape, dtype)
    t = kmajor_tiles(w, rows, cols)
    assert t.shape == (*shape[:-2], cols // per, rows, per) and t.is_contiguous()
    assert torch.equal(kmajor_untile(t, *shape[-2:]), w)
    full = kmajor_untile(t, rows, cols)
    pad = torch.ones_like(full, dtype=torch.bool)
    pad[..., : shape[-2], : shape[-1]] = False
    assert not full[pad].any()
    # Element (r, k) at [k // per, r, k % per].
    r, k = shape[-2] - 1, shape[-1] - 1
    assert torch.equal(t[..., k // per, r, k % per], w[..., r, k])


def test_kmajor_tiles_rejects_bad_geometry():
    w = torch.zeros(8, 24, dtype=torch.bfloat16)
    for rows, cols in ((4, 24), (8, 16), (8, 28)):
        with pytest.raises(ValueError):
            kmajor_tiles(w, rows, cols)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=str)
@pytest.mark.parametrize("k,n,np_,chunk", [(384, 128, 128, None), (1024, 256, 256, 128),
                                           (64, 136, 136, 128), (64, 136, 256, 64),
                                           (96, 72, 128, 32)])
def test_chained_matmul_b_tiles_as_the_kernel_reads_them(dtype, k, n, np_, chunk):
    """Row 26 packs Bᵀ [N, K] to [K·es/16, np, 16/es]; stage c of ``chunk``
    bytes of K is bytes [c·np·chunk, (c+1)·np·chunk), and warpgroup columns
    cbase.. of K step s read (2s·np + cbase)·16 with LBO = np·16, SBO = 128.
    ``chunk`` None: B resident, one stage of all of K."""
    es = torch.tensor([], dtype=dtype).element_size()
    kb = k * es
    chunk = chunk or kb
    b = _draw((k, n), dtype, seed=k + n)
    bt = kmajor_tiles(b.t(), np_, k)
    padded = torch.zeros(k, np_, dtype=dtype)
    padded[:, :n] = b
    flat = bt.view(-1)
    for c in range(kb // chunk):
        stage = flat[c * np_ * chunk // es : (c + 1) * np_ * chunk // es]
        for s in range(chunk // 32):
            for cbase, width in ((0, min(np_, 128)), (np_ - min(np_, 128), min(np_, 128))):
                got = _read(stage, (2 * s * np_ + cbase) * 16, np_ * 16, 128, width, 32)
                k0 = (c * chunk + 32 * s) // es
                want = padded[k0 : k0 + 32 // es, cbase : cbase + width].t()
                assert torch.equal(got, want)


@pytest.mark.parametrize("d,hid,dims", [(100, 200, (112, 224, 104)), (36, 72, (48, 96, 104)),
                                        (112, 64, (112, 64, 112))])
def test_gin_mlp_tiles_as_the_kernel_reads_them(d, hid, dims):
    """Row 8's bf16 tiles per layer: W1 chunk c (32 hidden units) of K step
    ks at (2ks·H' + 32c)·16 with LBO = H'·16; W2 K step s of chunk c at
    (4c + 2s)·N2·16 with LBO = N2·16; SBO = 128 for both. Pads zero."""
    L = 3
    dp, hp, n2 = dims
    w1 = _draw((L * hid, d), torch.bfloat16, seed=1)
    w2 = _draw((L * d, hid), torch.bfloat16, seed=2)
    w1t, w2t = local_layer.gin_mlp_tiles(w1, w2, L, dims)
    assert w1t.shape == (L, dp // 8, hp, 8) and w2t.shape == (L, hp // 8, n2, 8)
    for l in range(L):
        w1p = torch.zeros(hp, dp, dtype=torch.bfloat16)
        w1p[:hid, :d] = w1[l * hid : (l + 1) * hid]
        w2p = torch.zeros(n2, hp, dtype=torch.bfloat16)
        w2p[:d, :hid] = w2[l * d : (l + 1) * d]
        assert torch.equal(kmajor_untile(w1t[l], hp, dp), w1p)
        assert torch.equal(kmajor_untile(w2t[l], n2, hp), w2p)
        for c in range(hp // 32):
            for ks in range(dp // 16):
                got = _read(w1t[l], (2 * ks * hp + 32 * c) * 16, hp * 16, 128, 32, 32)
                assert torch.equal(got, w1p[32 * c : 32 * c + 32, 16 * ks : 16 * ks + 16])
            for s in range(2):
                got = _read(w2t[l], (4 * c + 2 * s) * n2 * 16, n2 * 16, 128, n2, 32)
                k0 = 32 * c + 16 * s
                assert torch.equal(got, w2p[:, k0 : k0 + 16])
