"""The host packing of ``wgmma`` operands (``flowgnn_tpu_torch.ops.tiles``)
and its users: row 26's B (``bench.matmul_shapes``), the bf16 GIN MLP's
weight chunks of rows 1, 8 and 13 (``ops.local_layer.gin_mlp_tiles``), with
the streamed ring that feeds them and the act operand they multiply, and the
one-product weight chunks of rows 9, 2, 3, 4, 5, 20 and 22
(``ops.local_layer.linear_tiles``: GCN's next conv, PNA's tower, DGN's
posttrans, GAT's glue; rows 20 and 22 one layer's of rows 3 and 4), with
their ring and the x, stats, channel and feat operands they multiply.

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
    """The bf16 GIN MLP's weight chunks (``csrc/gin_mlp.cuh``) per layer:
    chunk c is W1's rows 32c..32c+31 then W2's columns 32c..32c+31; in it,
    W1's K step ks at ks·1024 bytes with LBO = 32·16, and W2's K step s at
    D'·64 + s·N2·32 bytes with LBO = N2·16; SBO = 128 for both. Pads zero."""
    L = 3
    dp, hp, n2 = dims
    assert local_layer.gin_mlp_geometry(d, hid) == (dp, hp, n2, hp // 32, (dp + n2) * 32)
    w1 = _draw((L * hid, d), torch.bfloat16, seed=1)
    w2 = _draw((L * d, hid), torch.bfloat16, seed=2)
    tiles = local_layer.gin_mlp_tiles(w1, w2, L)
    assert tiles.shape == (L, hp // 32, (dp + n2) * 32) and tiles.is_contiguous()
    for l in range(L):
        w1p, w2p = _padded_weights(w1, w2, l, d, hid, dims)
        for c in range(hp // 32):
            _check_chunk(tiles[l, c], w1p, w2p, c, dp, n2)


def _padded_weights(w1, w2, l, d, hid, dims):
    dp, hp, n2 = dims
    w1p = torch.zeros(hp, dp, dtype=torch.bfloat16)
    w1p[:hid, :d] = w1[l * hid : (l + 1) * hid]
    w2p = torch.zeros(n2, hp, dtype=torch.bfloat16)
    w2p[:d, :hid] = w2[l * d : (l + 1) * d]
    return w1p, w2p


def _check_chunk(chunk, w1p, w2p, c, dp, n2):
    """Chunk c read through the MLP's descriptors: the z product's B (32
    hidden units × 16 of K a step) and the out product's B (N2 × 16)."""
    for ks in range(dp // 16):
        got = _read(chunk, ks * 2 * 32 * 16, 32 * 16, 128, 32, 32)
        assert torch.equal(got, w1p[32 * c : 32 * c + 32, 16 * ks : 16 * ks + 16])
    for s in range(2):
        got = _read(chunk, dp * 64 + 2 * s * n2 * 16, n2 * 16, 128, n2, 32)
        k0 = 32 * c + 16 * s
        assert torch.equal(got, w2p[:, k0 : k0 + 16])


# The bf16 MLP's widths in the card tests and the models: D' = 48, H' = 96;
# the registry's D = 100, H = 200; and H = 512 (16 chunks, past a resident
# footprint).
MLP_WIDTHS = [(36, 72), (100, 200), (100, 512)]


def _ring_schedule(stages: int, total: int, chunks: int):
    """The weight ring as ``gin_mlp.cuh``'s ``Ring`` and ``run`` drive it
    over ``total`` chunks, ``chunks`` a layer: the first ``stages`` loads
    before the first layer; per layer, after chunk c's first product
    (c > 0) chunk c − 1's buffer is released, and after the layer's last
    product its last chunk's; a release of chunk i loads chunk i + stages.
    Yields ("load", i) and ("use", i) in order."""
    for i in range(min(stages, total)):
        yield "load", i
    for first in range(0, total, chunks):
        for c in range(chunks):
            yield "use", first + c
            if c > 0 and first + c - 1 + stages < total:
                yield "load", first + c - 1 + stages
        if first + chunks - 1 + stages < total:
            yield "load", first + chunks - 1 + stages


@pytest.mark.parametrize("d,hid", MLP_WIDTHS, ids=[f"D{d}-H{h}" for d, h in MLP_WIDTHS])
@pytest.mark.parametrize("stages", [2, 5, 7, 16])
@pytest.mark.parametrize("layers", [1, 3], ids=["row13", "rows1-8"])
def test_gin_mlp_ring_streams_each_chunk_as_the_kernel_reads_it(d, hid, stages, layers):
    """The streamed ring: chunk i of the sequence (layer i // C, chunk
    i % C) lands in buffer i % S at byte (i % S)·chunk_bytes, its mbarrier
    in phase i // S (the parity the consumers wait on), and a buffer is
    refilled only after its chunk was used; every chunk, read back from its
    buffer through the MLP's descriptors, is that layer's W1 / W2 slice.
    Row 13 streams one layer's C chunks (``layers`` 1), rows 1 and 8 all
    L·C of the model."""
    dp, hp, n2, chunks, elems = local_layer.gin_mlp_geometry(d, hid)
    stages = local_layer.ring_stages(lambda s: s, chunks, stages)
    total = layers * chunks
    w1 = _draw((layers * hid, d), torch.bfloat16, seed=3)
    w2 = _draw((layers * d, hid), torch.bfloat16, seed=4)
    src = local_layer.gin_mlp_tiles(w1, w2, layers).view(-1)
    ring = torch.zeros(stages * elems, dtype=torch.bfloat16)
    held = [None] * stages  # the chunk each buffer holds
    phase = [0] * stages  # completed loads per buffer's mbarrier
    used = set()
    for what, i in _ring_schedule(stages, total, chunks):
        b = i % stages
        if what == "load":
            assert held[b] is None or held[b] in used, f"buffer {b} refilled before use"
            ring[b * elems : (b + 1) * elems] = src[i * elems : (i + 1) * elems]
            held[b], phase[b] = i, phase[b] + 1
            continue
        assert held[b] == i and (phase[b] - 1) % 2 == (i // stages) % 2
        used.add(i)
        l, c = divmod(i, chunks)
        w1p, w2p = _padded_weights(w1, w2, l, d, hid, (dp, hp, n2))
        _check_chunk(ring[b * elems : (b + 1) * elems], w1p, w2p, c, dp, n2)
    assert used == set(range(total))


@pytest.mark.parametrize("d,hid", MLP_WIDTHS, ids=[f"D{d}-H{h}" for d, h in MLP_WIDTHS])
def test_gin_mlp_act_layout_as_the_kernel_reads_it(d, hid):
    """act in wgmma's A layout [D'/8][128][8] (``gin_mlp.cuh``:
    ``act_index``), as rows 1 and 8 write it element by element and row 13
    as bf16 pairs (columns c, c + 1 of an even c are adjacent, one 4-byte
    store): warpgroup wg's K step ks, read through the descriptor at byte
    (2ks·128 + 64wg)·16 with LBO = 128·16 and SBO = 128, is rows
    64wg..64wg+63 and columns 16ks..16ks+15 of act, pad columns zero."""
    dp = local_layer.gin_mlp_geometry(d, hid)[0]
    act_index = lambda r, c: ((c >> 3) * 128 + r) * 8 + (c & 7)
    act = _draw((128, d), torch.bfloat16, seed=5)
    flat = torch.zeros(dp * 128, dtype=torch.bfloat16)
    for r in range(128):
        for c in range(0, d, 2):
            at = act_index(r, c)
            assert act_index(r, c + 1) == at + 1 and at % 2 == 0
            flat[at] = act[r, c]
            if c + 1 < d:
                flat[at + 1] = act[r, c + 1]
    padded = torch.zeros(128, dp, dtype=torch.bfloat16)
    padded[:, :d] = act
    for wg in range(2):
        for ks in range(dp // 16):
            got = _read(flat, (2 * ks * 128 + 64 * wg) * 16, 128 * 16, 128, 64, 32)
            assert torch.equal(got, padded[64 * wg : 64 * wg + 64, 16 * ks : 16 * ks + 16])


@pytest.mark.parametrize("chunks", [1, 3, 7, 16])
def test_gin_mlp_ring_never_waits_on_itself(chunks):
    """The wrapper's ring depth (``ring_stages``): the most buffers that fit,
    at most a layer's chunks, and never one buffer for a layer of several
    chunks, on which the ring would wait for its own refill; the schedule
    then feeds every use from a loaded buffer (``_ring_schedule``)."""
    for budget in range(0, 20):
        stages = local_layer.ring_stages(lambda s: s, chunks, budget)
        assert stages == max(min(2, chunks), min(budget, chunks))
        held = {}
        for what, i in _ring_schedule(stages, 3 * chunks, chunks):
            if what == "load":
                held[i % stages] = i
            else:
                assert held.get(i % stages) == i
    # One buffer under a layer of two chunks: chunk 1 would be used before
    # the release of chunk 0 loads it.
    order = list(_ring_schedule(1, 2, 2))
    assert order.index(("use", 1)) < order.index(("load", 1))


# Rows 9 and 3 (``csrc/linear_wgmma.cuh``): (kernel, D, the product's K, N).
LINEAR_CASES = [("gcn", 100, 100, 104), ("gcn", 32, 32, 104), ("gcn", 112, 112, 112),
                ("pna", 80, 320, 240), ("pna", 32, 128, 240),
                ("dgn", 100, 200, 104), ("dgn", 32, 64, 104), ("dgn", 112, 224, 112),
                ("gat", 64, 64, 128), ("gat", 32, 32, 128), ("gat", 16, 16, 128)]
LINEAR_IDS = [f"{k}-D{d}" for k, d, _, _ in LINEAR_CASES]


def _linear_weights(kind: str, d: int, layers: int, seed: int):
    """(the packed chunks, each layer's Bᵀ [N, K'] zero-padded) of seeded
    bf16 weights: GCN's next convs [L, out, in] (``gcn_conv_tiles``), PNA's
    towers [L, scaler, out, 4D] (``pna_tower_tiles``, scaler p's outputs at
    rows 80p..80p+D−1 of Bᵀ), DGN's posttrans [L, out, 2D]
    (``dgn_posttrans_tiles``), GAT's glue [L, out, H·D] twice
    (``gat_glue_tiles``: proj's outputs at rows 0.., skip's at 64..)."""
    if kind == "gcn":
        w = _draw((layers, d, d), torch.bfloat16, seed)
        tiles = local_layer.gcn_conv_tiles(w)
        n, k = local_layer.gcn_conv_n(d), d
        bt = [w[l] for l in range(layers)]
    elif kind == "dgn":
        w = _draw((layers, d, 2 * d), torch.bfloat16, seed)
        tiles = local_layer.dgn_posttrans_tiles(w)
        n, k = local_layer.gcn_conv_n(d), 2 * d
        bt = [w[l] for l in range(layers)]
    elif kind == "gat":
        proj = _draw((layers, d, d), torch.bfloat16, seed)
        skip = _draw((layers, d, d), torch.bfloat16, seed + 1)
        tiles = local_layer.gat_glue_tiles(proj, skip)
        n, k = 2 * local_layer.GAT_PITCH, d
        bt = []
        for l in range(layers):
            b = torch.zeros(n, k, dtype=torch.bfloat16)
            b[:d], b[local_layer.GAT_PITCH : local_layer.GAT_PITCH + d] = proj[l], skip[l]
            bt.append(b)
    else:
        w = _draw((layers, 3, d, 4 * d), torch.bfloat16, seed)
        tiles = local_layer.pna_tower_tiles(w)
        n, k = 3 * local_layer.PNA_PITCH, 4 * d
        bt = []
        for l in range(layers):
            b = torch.zeros(n, k, dtype=torch.bfloat16)
            for p in range(3):
                b[80 * p : 80 * p + d] = w[l, p]
            bt.append(b)
    kp = local_layer.linear_geometry(k, n)[0]
    padded = []
    for b in bt:
        full = torch.zeros(n, kp, dtype=torch.bfloat16)
        full[: b.shape[0], :k] = b
        padded.append(full)
    return tiles, padded


def _check_linear_chunk(chunk, btp, c, n):
    """Chunk c read through the product's descriptors (``linear_wgmma.cuh``:
    ``run``): K step s at byte 2s·n·16 with LBO = n·16 and SBO = 128 is B's
    rows 32c + 16s..32c + 16s + 15 as the [n, 16] B operand."""
    for s in range(2):
        got = _read(chunk, 2 * s * n * 16, n * 16, 128, n, 32)
        assert torch.equal(got, btp[:, 32 * c + 16 * s : 32 * c + 16 * s + 16])


@pytest.mark.parametrize("kind,d,k,n", LINEAR_CASES, ids=LINEAR_IDS)
def test_linear_tiles_as_the_kernel_reads_them(kind, d, k, n):
    """The weight chunks of rows 9 and 3, per layer [K'/32, 32·N] (K' = K
    padded to 32: D = 100 → 128, 4D = 320 → 320), each chunk read back
    through the descriptors is B's 32 rows, pads zero; and the product the
    kernel computes from them (A [128, K'] in the A layout, 64 rows a
    warpgroup, K steps of 16) is A·B."""
    layers = 3
    kp, chunks, elems = local_layer.linear_geometry(k, n)
    assert kp % 32 == 0 and kp - k < 32 and elems == 32 * n
    tiles, padded = _linear_weights(kind, d, layers, seed=d + n)
    assert tiles.shape == (layers, chunks, elems) and tiles.is_contiguous()
    for l in range(layers):
        for c in range(chunks):
            _check_linear_chunk(tiles[l, c], padded[l], c, n)
    # The product of layer 1, as run() issues it.
    a = torch.zeros(128, kp, dtype=torch.bfloat16)
    a[:, :k] = _draw((128, k), torch.bfloat16, seed=7)
    flat = _a_layout(a)
    acc = torch.zeros(128, n, dtype=torch.float64)
    for c in range(chunks):
        for s in range(2):
            ks = 2 * c + s
            b = _read(tiles[1, c], 2 * s * n * 16, n * 16, 128, n, 32).double()
            for wg in range(2):
                aw = _read(flat, (2 * ks * 128 + 64 * wg) * 16, 128 * 16, 128, 64, 32).double()
                acc[64 * wg : 64 * wg + 64] += aw @ b.t()
    torch.testing.assert_close(acc, a.double() @ padded[1].double().t())


def _a_layout(a: torch.Tensor) -> torch.Tensor:
    """[128, K'] as the kernels write it into the A layout [K'/8][128][8]
    (``linear_wgmma.cuh``: ``a_index``), flat."""
    a_index = lambda r, c: ((c >> 3) * 128 + r) * 8 + (c & 7)
    flat = torch.zeros(a.numel(), dtype=a.dtype)
    r, c = torch.meshgrid(torch.arange(a.shape[0]), torch.arange(a.shape[1]), indexing="ij")
    flat[a_index(r, c).reshape(-1)] = a.reshape(-1)
    return flat


def test_model_tiles_equal_the_wrappers_own_packing():
    """What the models hand rows 9 and 3 (``gcn.conv_tiles`` from
    ``conv_w[1:]``, ``pna.tower_tiles`` from ``conv_w``) is what the
    wrappers pack from the operands they check (``wn_all``, ``w_all``) when
    no chunks are given; f32 hands none."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import gcn, pna
    from flowgnn_tpu_torch.params import loaders

    p = loaders.params_from_numpy(loaders.synthetic_gcn_params(3, dim=36, layers=3), BF16, "cpu")
    L, d = p["conv_w"].shape[:2]
    wn_all = p["conv_w"][1:].transpose(1, 2).reshape((L - 1) * d, d).contiguous()
    assert torch.equal(gcn.conv_tiles(p, BF16), local_layer.gcn_conv_tiles(
        wn_all.view(L - 1, d, d).transpose(1, 2)))
    assert gcn.conv_tiles(p, FLOAT32) is None
    p = loaders.params_from_numpy(loaders.synthetic_pna_params(3, dim=24, layers=2), BF16, "cpu")
    w_all = p["conv_w"].reshape(2, 24, 3, 96).permute(0, 3, 2, 1).reshape(2 * 96, 72)
    assert torch.equal(pna.tower_tiles(p, BF16), local_layer.pna_tower_tiles(
        w_all.view(2, 96, 3, 24).permute(0, 2, 3, 1)))
    assert pna.tower_tiles(p, FLOAT32) is None


def test_dgn_gat_model_tiles_equal_the_wrappers_own_packing():
    """What the models hand rows 4 and 5 (``dgn.posttrans_tiles`` from
    ``posttrans_w``, ``gat.glue_tiles`` from ``proj_w[1:]`` and
    ``skip_w[1:]``) is what the wrappers pack from the operands they check
    (``w_all``; ``proj_w`` and ``skip_w`` right-multiplied) when no chunks
    are given; f32 hands none."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import dgn, gat
    from flowgnn_tpu_torch.params import loaders

    p = loaders.params_from_numpy(loaders.synthetic_dgn_params(3, dim=36, layers=3), BF16, "cpu")
    L, d = p["posttrans_w"].shape[:2]
    w_all = p["posttrans_w"].reshape(L, d, 2 * d).transpose(1, 2).reshape(L * 2 * d, d)
    assert torch.equal(dgn.posttrans_tiles(p, BF16), local_layer.dgn_posttrans_tiles(
        w_all.contiguous().view(L, 2 * d, d).transpose(1, 2)))
    assert dgn.posttrans_tiles(p, FLOAT32) is None
    p = loaders.params_from_numpy(loaders.synthetic_gat_params(3, dim=16, heads=3, layers=3),
                                  BF16, "cpu")
    hd = 48
    right = lambda w: w.reshape(-1, hd, hd).transpose(1, 2).reshape(-1, hd).contiguous()
    right_t = lambda w: w.view(2, hd, hd).transpose(1, 2)
    assert torch.equal(gat.glue_tiles(p, BF16), local_layer.gat_glue_tiles(
        right_t(right(p["proj_w"][1:])), right_t(right(p["skip_w"][1:]))))
    assert gat.glue_tiles(p, FLOAT32) is None


@pytest.mark.parametrize("name", ["pna", "dgn"], ids=["row20", "row22"])
def test_rows_20_22_layer_tiles_equal_the_model_slices(name):
    """What the per-layer slot paths hand rows 20 and 22 for layer l (layer
    l's slice of ``pna.tower_tiles`` / ``dgn.posttrans_tiles``, packed once
    for all layers) is what the wrappers pack from that layer's ``w_cat`` /
    ``w_post`` when no chunks are given (``pna_layer_tiles``,
    ``dgn_layer_tiles``): the same chunks, which read back through the
    product's descriptors as the layer's Bᵀ; f32 hands none."""
    from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
    from flowgnn_tpu_torch.models import dgn, pna
    from flowgnn_tpu_torch.params import loaders

    d, L = (24, 3) if name == "pna" else (36, 3)
    if name == "pna":
        p = loaders.params_from_numpy(loaders.synthetic_pna_params(3, dim=d, layers=L), BF16, "cpu")
        all_tiles, pack = pna.tower_tiles(p, BF16), local_layer.pna_layer_tiles
        k, n, key = 4 * d, 3 * local_layer.PNA_PITCH, "w_cat"
    else:
        p = loaders.params_from_numpy(loaders.synthetic_dgn_params(3, dim=d, layers=L), BF16, "cpu")
        all_tiles, pack = dgn.posttrans_tiles(p, BF16), local_layer.dgn_layer_tiles
        k, n, key = 2 * d, local_layer.gcn_conv_n(d), "w_post"
    kp, chunks, elems = local_layer.linear_geometry(k, n)
    h = torch.zeros(8, d, dtype=torch.bfloat16)
    for l in range(L):
        if name == "pna":
            w = pna.layer_operands(p, _slot_geom_batch(), l, h, (h[:, :1],) * 3, all_tiles)
            tiles = w["tower_tiles"]
        else:
            terms = (h[:, 0], None, h[:, 0], h[:, 0], h[:, :1])  # eig, eig_w, sums, degree
            w = dgn.layer_operands(p, _slot_geom_batch(), l, h, terms, None, all_tiles)
            tiles = w["posttrans_tiles"]
        assert tiles.shape == (chunks, elems)
        assert tiles.data_ptr() == all_tiles[l].data_ptr()  # a slice, not a copy
        assert torch.equal(tiles, pack(w[key]))
        bt = torch.zeros(n, kp, dtype=torch.bfloat16)
        for c in range(chunks):
            for s in range(2):
                bt[:, 32 * c + 16 * s : 32 * c + 16 * s + 16] = _read(
                    tiles[c], 2 * s * n * 16, n * 16, 128, n, 32)
        # Bᵀ's row 80j + c is output column c of scaler j (PNA), row c column c (DGN).
        w_right = w[key].float()  # [K, outputs]
        if name == "pna":
            for j in range(3):
                assert torch.equal(bt[80 * j : 80 * j + d, :k].float(),
                                   w_right[:, j * d : (j + 1) * d].t())
        else:
            assert torch.equal(bt[:d, :k].float(), w_right.t())
        assert not bt[:, k:].any()
    with_f32 = (pna.tower_tiles if name == "pna" else dgn.posttrans_tiles)(p, FLOAT32)
    assert with_f32 is None


def _slot_geom_batch() -> dict:
    """The slot-geometry keys the per-layer operand functions read."""
    return {"slot_src": torch.zeros(8, 1, dtype=torch.int32),
            "slot_geom": torch.zeros(8, 1, dtype=torch.int32)}


@pytest.mark.parametrize("kind,d,layers", [("gcn", 100, 4), ("pna", 80, 4), ("pna", 32, 2),
                                           ("dgn", 100, 4), ("gat", 64, 4)],
                         ids=["row9-D100", "row3-D80", "row3-D32", "row4-D100", "row5-HD64"])
@pytest.mark.parametrize("stages", [2, 3, 4, 6, 10])
def test_linear_ring_streams_each_chunk_as_the_kernel_reads_it(kind, d, layers, stages):
    """The ring of rows 9 and 3 (``gin_mlp.cuh``'s ``Ring``, driven by
    ``linear_wgmma.cuh``'s ``run``: chunk c − 1's buffer is released once
    chunk c's group is issued and c − 1's has completed, the last chunk's
    after the product) over every layer's chunks, one sequence (row 9: the
    L − 1 next convs, 4 chunks each at D = 100; row 3: the L towers, 10 at
    D = 80, 4 at D = 32): no buffer is refilled before its chunk was used,
    each use finds its chunk in buffer i % S in phase i // S, and the chunk
    read back from the buffer is that layer's B. Row 2 runs row 9's ring;
    row 4's posttrans streams 7 chunks a layer at D = 100, row 5's glue the
    L − 1 next layers' 2 chunks at H·D = 64."""
    tiles, padded = _linear_weights(kind, d, layers, seed=3)
    n = padded[0].shape[0]
    chunks, elems = tiles.shape[1:]
    stages = local_layer.ring_stages(lambda s: s, chunks, stages)
    assert stages >= min(2, chunks)
    total = layers * chunks
    src = tiles.reshape(-1)
    ring = torch.zeros(stages * elems, dtype=torch.bfloat16)
    held, phase, used = [None] * stages, [0] * stages, set()
    for what, i in _ring_schedule(stages, total, chunks):
        b = i % stages
        if what == "load":
            assert held[b] is None or held[b] in used, f"buffer {b} refilled before use"
            ring[b * elems : (b + 1) * elems] = src[i * elems : (i + 1) * elems]
            held[b], phase[b] = i, phase[b] + 1
            continue
        assert held[b] == i and (phase[b] - 1) % 2 == (i // stages) % 2
        used.add(i)
        l, c = divmod(i, chunks)
        _check_linear_chunk(ring[b * elems : (b + 1) * elems], padded[l], c, n)
    assert used == set(range(total))


@pytest.mark.parametrize("kind,d,k,n", LINEAR_CASES, ids=LINEAR_IDS)
def test_linear_a_operands_as_the_kernel_reads_them(kind, d, k, n):
    """The A operands of rows 9, 3, 4 and 5 in the A layout [K'/8][128][8]:
    row 9's x written as bf16 pairs (columns c, c + 1 of an even c adjacent,
    one 4-byte store), row 3's stats, row 4's channels and row 5's feat
    element by element at column part·D + c of [mean | min | max | std],
    [a1 | a2] or feat; warpgroup wg's K step ks read through the descriptor
    at byte (2ks·128 + 64wg)·16 with LBO = 128·16 and SBO = 128 is rows
    64wg..64wg+63 and columns 16ks..16ks+15, the pad columns zero. And row
    3's epilogue finds scaler p's output for column c in accumulator 4j + e
    + 40p of the thread that holds column c (j = c // 8), row 5's finds
    skip's in accumulator 4j + e + 32."""
    kp = local_layer.linear_geometry(k, n)[0]
    a_index = lambda r, c: ((c >> 3) * 128 + r) * 8 + (c & 7)
    vals = _draw((128, k), torch.bfloat16, seed=k)
    flat = torch.zeros(kp * 128, dtype=torch.bfloat16)
    for r in range(128):
        if kind == "gcn":
            for c in range(0, k, 2):
                at = a_index(r, c)
                assert at % 2 == 0 and a_index(r, c + 1) == at + 1
                flat[at], flat[at + 1] = vals[r, c], vals[r, c + 1]
        else:
            for part in range(k // d):
                for c in range(d):
                    flat[a_index(r, part * d + c)] = vals[r, part * d + c]
    padded = torch.zeros(128, kp, dtype=torch.bfloat16)
    padded[:, :k] = vals
    for wg in range(2):
        for ks in range(kp // 16):
            got = _read(flat, (2 * ks * 128 + 64 * wg) * 16, 128 * 16, 128, 64, 32)
            assert torch.equal(got, padded[64 * wg : 64 * wg + 64, 16 * ks : 16 * ks + 16])
    if kind == "pna":
        # Thread t's accumulator 4j + e: row 64wg + 16w + g (+ 8), column 8j + 2q (+ 1).
        col = lambda t, j, e: 8 * j + 2 * (t % 4) + (e & 1)
        for t in range(256):
            for j in range(local_layer.PNA_PITCH // 8):
                for e in range(4):
                    for p in range(3):
                        assert col(t, j + 10 * p, e) == col(t, j, e) + 80 * p
                        assert 4 * (j + 10 * p) + e == 4 * j + e + 40 * p
    if kind == "gat":
        col = lambda t, j, e: 8 * j + 2 * (t % 4) + (e & 1)
        for t in range(256):
            for j in range(local_layer.GAT_PITCH // 8):
                for e in range(4):
                    assert col(t, j + 8, e) == col(t, j, e) + local_layer.GAT_PITCH
                    assert 4 * (j + 8) + e == 4 * j + e + 32
