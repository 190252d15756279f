"""GIN / GIN-VN over slot batches at windows above 128, which row 1
(``gin_local_model_slots``) takes on a thread-block cluster of W/128 blocks:
at W=256 and W=512, a few molhiv-shaped graphs and one large graph, at a
small width (D=16, H=32, L=2), the port's slot layout against the JAX
package's key by key, row 1's plain version against the Pallas kernel in
interpret mode, the forward against the JAX forward, and the forward's
routing to row 1. Then the bf16 kernels' weight chunks (rows 1, 8 and 13),
packed once per weight set over a forward of several buckets and layers and
again after an in-place update of the weights."""

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import gin
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params
from test_torch_cuda import _port
from test_torch_host import _assert_batches_equal
from test_torch_local_layer import _jax_kernel

D, H, L = 16, 32, 2
SMALL = 6  # molhiv-shaped graphs beside the large one
# (window, the large graph's nodes): the window choose_geometry gives it.
CASES = [(256, 250), (512, 400)]
IDS = [f"W{w}" for w, _ in CASES]


def _graphs(mod, name: str, big: int):
    """Six molhiv-shaped graphs and one of ``big`` nodes, through the
    model's transforms (GIN-VN's analytic virtual node), from ``mod``'s
    host layer (the JAX package's or the port's)."""
    reg = jr if mod is js else tr
    graphs = mod.synthetic_molhiv(SMALL, seed=7) + [
        mod.random_molecule_graph(np.random.default_rng(big), num_nodes=big)]
    return reg.apply_transforms(reg.get(name), graphs)


def _caps(window: int) -> dict:
    return dict(node_capacity=2 * window - 1, edge_capacity=4096, graph_capacity=16)


def _batches(name: str, window: int, big: int) -> dict:
    """The slot batch at ``window`` from both packages and the port's plain
    edge-list batch of the same graphs."""
    jgs, tgs = _graphs(js, name, big), _graphs(ts, name, big)
    assert tb.choose_geometry(name, max(g.num_nodes for g in tgs))[0] == window
    jp = jg.pack_graphs_aligned(jgs, window=window, **_caps(window))
    tp = tg.pack_graphs_aligned(tgs, window=window, **_caps(window))
    return dict(
        jax_slot=jb.as_batch(jp, blocked="local_slots", window=window),
        slot=tb.as_batch(tp, blocked="local_slots", window=window),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **_caps(window))), "cpu"),
    )


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_slot_layout_above_128_equals_jax(name, window, big, monkeypatch):
    """The slot layout at W=256 and W=512 equals the JAX package's key by
    key; no edge spills, so the bucket carries the prefix layout row 1
    reads, whose centre is W/2."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = _batches(name, window, big)
    # The JAX package keeps the slot stacks in a float dtype for its TPU
    # gather (bf16 up to W=256, f32 above), the port as int32: the same
    # indices.
    jax_slot = dict(b["jax_slot"])
    for k in ("slot_stack", "slot_pstack"):
        stack = np.asarray(jax_slot[k])
        assert np.array_equal(stack.astype(np.int64), b["slot"][k]), k
        jax_slot[k] = stack.astype(np.int32)
    _assert_batches_equal(jax_slot, b["slot"])
    slot = b["slot"]
    assert slot["slot_geom"].shape[0] == window and "slot_meta" in slot
    assert not slot["slot_spill_mask"].any()
    src = slot["slot_meta"][:, 0].astype(np.int64) + window // 2
    assert ((src >= 0) & (src <= window)).all() and (src < window).any()


def _slot_operands(name: str, window: int, big: int, seed: int = 31) -> dict:
    """Row 1's operands on the slot batch: the layout's own, seeded random
    h0 and weights, as numpy arrays."""
    batch = _batches(name, window, big)["slot"]
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=f32(n, D), pool_gl=batch["pool_gl"],
        ee_tables=f32(L * 13, D), w1_all=f32(L * H, D), b1_all=f32(L, H),
        w2_all=f32(L * D, H), b2_all=f32(L, D),
        eps_all=(1 + f32(L, 1)).astype(np.float32), pred_w=f32(D, 1),
        window=window, slots=slots, num_layers=L, gmax=tb.POOL_GMAX,
        prefix_caps=tb.slot_prefix_caps(batch, slots),
        vn_col=batch["vn_mask"].astype(np.float32) if name == "gin-vn" else None,
    )


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_row1_plain_version_above_128_matches_jax(name, window, big, monkeypatch):
    """``gin_local_model_slots_ref`` against the Pallas
    ``gin_local_model_slots`` in interpret mode at W=256 and W=512, f32 to
    1e-5: the large graph's rows span two and four of row 1's 128-row
    blocks, and its VN row pools over all of them."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _slot_operands(name, window, big)
    expect = _jax_kernel("gin_local_model_slots", ops)
    got = local_layer.gin_local_model_slots(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def _params():
    return synthetic_gin_params(4, dim=D, hidden=H, layers=L)


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_gin_forward_on_slots_above_128_matches_jax(name, window, big, monkeypatch):
    """The forward over the W=256 / W=512 slot batch (row 1's plain
    version) against the JAX forward (its slot kernel in interpret mode),
    f32 to 1e-5, ε used (not zeroed) for GIN-VN; and against the port's own
    plain edge-list path."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    b = _batches(name, window, big)
    fpga_eps = name == "gin"
    p32 = params_from_numpy(_params(), tn.FLOAT32, "cpu")
    j32 = jb.prepare_params(_params(), jn.FLOAT32)
    got = tr.get(name).forward(p32, tb.to_device(b["slot"], "cpu"), tn.FLOAT32, fpga_eps=fpga_eps)
    expect = np.asarray(jr.get(name).forward(j32, b["jax_slot"], jn.FLOAT32, fpga_eps=fpga_eps))
    g = SMALL + 1
    assert got.dtype == torch.float32 and got.shape == expect.shape
    np.testing.assert_allclose(got[:g].numpy(), expect[:g], rtol=1e-5, atol=1e-5)
    plain = tr.get(name).forward(p32, b["plain"], tn.FLOAT32, fpga_eps=fpga_eps)
    np.testing.assert_allclose(got[:g].numpy(), plain[:g].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_gin_forward_routes_slots_above_128_to_row1(name, window, big, monkeypatch):
    """``gin.forward`` sends a W=256 / W=512 slot batch to row 1, one call
    per batch with the window and slot geometry of the batch, and not to the
    plain loop (whose message sum would call ``edge_segment_sum``)."""
    calls = []

    def counted(**ops):
        calls.append((ops["window"], ops["slots"], ops["prefix_caps"]))
        return local_layer.gin_local_model_slots(**ops)

    def plain_loop(*args, **kw):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(gin, "gin_local_model_slots", counted)
    monkeypatch.setattr(gin, "edge_segment_sum", plain_loop)
    batch = tb.to_device(_batches(name, window, big)["slot"], "cpu")
    p = params_from_numpy(_params(), tn.FLOAT32, "cpu")
    for _ in range(2):
        out = gin.forward(p, batch, tn.FLOAT32)
        assert out.shape == (batch["n_node"].shape[0], 1) and bool(out[: SMALL + 1].isfinite().all())
    slots = batch["slot_geom"].shape[-1]
    assert calls == [(window, slots, tb.slot_prefix_caps(batch, slots))] * 2


def _bf16_stream(name: str, layout, window: int, **kw) -> list:
    """Three buckets of molhiv-shaped graphs in ``layout`` at ``window``,
    on the CPU."""
    graphs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(30, seed=9))
    buckets = list(tg.pack_dataset(graphs, node_capacity=255, edge_capacity=1024,
                                   graph_capacity=12, align_window=window))
    assert len(buckets) >= 3
    return [tb.to_device(b, "cpu") for b in tb.as_batches_uniform(
        buckets, blocked=layout, window=window, **kw)]


def test_weight_tiles_packed_once_per_weight_set(monkeypatch):
    """The bf16 kernels' weight chunks (``local_layer.mlp_tiles``): one pack
    for a forward over several buckets through row 1 (slots), row 8 (ELL)
    and row 13 (ELL, layer by layer with intermediates), the same tensor
    handed to every launch (row 13 its layer's slice, equal to that layer's
    own packing); an in-place update of a weight packs again, and the new
    chunks hold the new weights."""
    packs = []
    real = local_layer.gin_mlp_tiles

    def counted(w1_all, w2_all, num_layers):
        packs.append(num_layers)
        return real(w1_all, w2_all, num_layers)

    monkeypatch.setattr(local_layer, "gin_mlp_tiles", counted)
    local_layer._MLP_TILES.clear()
    params = params_from_numpy(synthetic_gin_params(5, dim=D, hidden=3 * H, layers=3),
                               tn.BF16, "cpu")
    slots = _bf16_stream("gin", "local_slots", 128)
    ell = _bf16_stream("gin", "local_ell", 128, block=384)

    def forward_all():
        outs = [gin.forward(params, b, tn.BF16) for b in slots + ell]
        outs += [gin.forward(params, b, tn.BF16, return_intermediates=True)[0] for b in ell]
        return outs

    first = forward_all()
    assert packs == [3]
    tiles = gin.weight_tiles(params, tn.BF16)
    assert gin.slot_kernel_operands(params, slots[1], tn.BF16)["mlp_tiles"] is tiles
    assert gin.ell_kernel_operands(params, ell[2], tn.BF16)["mlp_tiles"] is tiles
    eps_all = gin.eps1_all(params, tn.BF16)
    h = tb.atom_embed(params["node_embedding"], ell[0]["node_feat"], tn.BF16)
    for l in range(3):
        got = gin.ell_layer_operands(params, ell[0], tn.BF16, l, h, tb.ell_meta(ell[0]),
                                     tb.ell_spill(ell[0]), eps_all)["mlp_tiles"]
        assert got.data_ptr() == tiles[l].data_ptr()
        assert torch.equal(got, real(params["mlp1_w"][l], params["mlp2_w"][l], 1)[0])
    assert gin.weight_tiles(params, tn.FLOAT32) is None
    assert packs == [3]

    with torch.no_grad():
        params["mlp2_w"][1].mul_(2)
    again = forward_all()
    assert packs == [3, 3]
    new = gin.weight_tiles(params, tn.BF16)
    assert new is not tiles and not torch.equal(new, tiles)
    L, hid, d = params["mlp1_w"].shape
    assert torch.equal(new, real(params["mlp1_w"].reshape(L * hid, d),
                                 params["mlp2_w"].reshape(L * d, hid), L))
    assert any(not torch.equal(a, b) for a, b in zip(first, again))
    assert packs == [3, 3]
