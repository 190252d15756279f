"""PNA over slot batches at windows above 128, which row 3
(``pna_local_model``) takes on a thread-block cluster of W/128 blocks: at
W=256 and W=512, a few molhiv-shaped graphs and one large graph, at a small
width (D=16, L=2), the port's slot layout against the JAX package's key by
key, row 3's plain version against the Pallas kernel in interpret mode, the
forward against the JAX forward and the port's plain path, and the
forward's routing to row 3. Then the bf16 weight chunks of rows 3 and 9,
packed once per weight set over a forward of several buckets and again after
an in-place update of the weights."""

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
from flowgnn_tpu_torch.models import gcn, pna
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders as tl
from test_torch_cuda import _port
from test_torch_host import _assert_batches_equal
from test_torch_local_layer import _jax_kernel

D, L = 16, 2
SMALL = 6  # molhiv-shaped graphs beside the large one
# (window, the large graph's nodes): the window choose_geometry gives it.
CASES = [(256, 250), (512, 400)]
IDS = [f"W{w}" for w, _ in CASES]


def _graphs(mod, big: int):
    """Six molhiv-shaped graphs and one of ``big`` nodes, through PNA's
    transforms, from ``mod``'s host layer (the JAX package's or the
    port's)."""
    reg = jr if mod is js else tr
    graphs = mod.synthetic_molhiv(SMALL, seed=8) + [
        mod.random_molecule_graph(np.random.default_rng(big + 1), num_nodes=big)]
    return reg.apply_transforms(reg.get("pna"), graphs)


def _caps(window: int) -> dict:
    return dict(node_capacity=2 * window - 1, edge_capacity=4096, graph_capacity=16)


def _batches(window: int, big: int) -> dict:
    """The slot batch at ``window`` from both packages and the port's plain
    edge-list batch of the same graphs."""
    jgs, tgs = _graphs(js, big), _graphs(ts, big)
    assert tb.choose_geometry("pna", max(g.num_nodes for g in tgs))[0] == window
    jp = jg.pack_graphs_aligned(jgs, window=window, **_caps(window))
    tp = tg.pack_graphs_aligned(tgs, window=window, **_caps(window))
    return dict(
        jax_slot=jb.as_batch(jp, blocked="local_slots", window=window),
        slot=tb.as_batch(tp, blocked="local_slots", window=window),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **_caps(window))), "cpu"),
    )


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_pna_slot_layout_above_128_equals_jax(window, big, monkeypatch):
    """The slot layout at W=256 and W=512 equals the JAX package's key by
    key; no edge spills, and the pooling layout is there, so the bucket is
    one row 3 takes."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = _batches(window, big)
    # The JAX package keeps the slot stacks in a float dtype for its TPU
    # gather, the port as int32: the same indices.
    jax_slot = dict(b["jax_slot"])
    for k in ("slot_stack", "slot_pstack"):
        stack = np.asarray(jax_slot[k])
        assert np.array_equal(stack.astype(np.int64), b["slot"][k]), k
        jax_slot[k] = stack.astype(np.int32)
    _assert_batches_equal(jax_slot, b["slot"])
    slot = b["slot"]
    assert slot["slot_geom"].shape[0] == window and "pool_gl" in slot
    assert not slot["slot_spill"].shape[-1] and not slot["slot_spill_mask"].any()
    src = slot["slot_src"]
    assert ((src >= 0) & (src <= window)).all() and (src >= 128).any()  # sources past block 0


def _slot_operands(window: int, big: int, seed: int = 33) -> dict:
    """Row 3's operands on the slot batch: the layout's own, the degree
    scalers of its graphs, seeded random h0 and weights, as numpy arrays."""
    batch = _batches(window, big)["slot"]
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    log_deg = np.log(batch["out_deg"] + 1.0)
    scale = np.where(log_deg > 0, tl.PNA_AVG_DEG / np.where(log_deg > 0, log_deg, 1), 1.0)
    return dict(
        slot_src=batch["slot_src"], h0=f32(n, D),
        inv_deg=(1 / np.maximum(batch["in_deg"], 1)).astype(np.float32),
        t=(log_deg / tl.PNA_AVG_DEG).astype(np.float32), scale=scale.astype(np.float32),
        w_all=f32(L * 4 * D, 3 * D), b_all=f32(L, D), pool_gl=batch["pool_gl"],
        mlp1_w=f32(D, 8), window=window, slots=slots, num_layers=L, gmax=tb.POOL_GMAX,
        min_init=pna.MAX_INIT, max_init=pna.MIN_INIT,
        prefix_caps=tb.slot_prefix_caps(batch, slots),
    )


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_row3_plain_version_above_128_matches_jax(window, big, monkeypatch):
    """``pna_local_model_ref`` against the Pallas ``pna_local_model`` in
    interpret mode at W=256 and W=512, f32 to 1e-5 of the output's scale:
    the large graph's rows and their slot sources span two and four of row
    3's 128-row blocks, and its pool sums 250-400 rows of h·mlp1_w in
    another order than the Pallas kernel's one-hot product."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _slot_operands(window, big)
    expect = _jax_kernel("pna_local_model", ops)
    got = local_layer.pna_local_model(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    scale = np.abs(expect).max()
    assert scale > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


def _params():
    return tl.synthetic_pna_params(5, dim=D, layers=L)


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_pna_forward_on_slots_above_128_matches_jax(window, big, monkeypatch):
    """The forward over the W=256 / W=512 slot batch (row 3's plain
    version) against the JAX forward (its slot kernel in interpret mode),
    f32 to 1e-5 as ``test_torch_pna`` holds W=128; and against the port's
    own plain edge-list path."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    b = _batches(window, big)
    p32 = tl.params_from_numpy(_params(), tn.FLOAT32, "cpu")
    got = tr.get("pna").forward(p32, tb.to_device(b["slot"], "cpu"), tn.FLOAT32)
    expect = np.asarray(jr.get("pna").forward(jb.prepare_params(_params(), jn.FLOAT32),
                                              b["jax_slot"], jn.FLOAT32))
    g = SMALL + 1
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect[:g]).max() > 1e-2
    np.testing.assert_allclose(got[:g].numpy(), expect[:g], rtol=1e-5, atol=1e-5)
    plain = tr.get("pna").forward(p32, b["plain"], tn.FLOAT32)
    np.testing.assert_allclose(got[:g].numpy(), plain[:g].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
def test_pna_forward_routes_slots_above_128_to_row3(window, big, monkeypatch):
    """``pna.forward`` sends a W=256 / W=512 slot batch with no spill tail
    and the pooling layout to row 3, one call per forward with the batch's
    window and slot geometry, and to neither per-layer kernel (rows 19 and
    20) nor the plain loop's aggregates."""
    calls = []

    def counted(**ops):
        calls.append((ops["window"], ops["slots"], ops["prefix_caps"]))
        return local_layer.pna_local_model(**ops)

    def other(*args, **kw):
        raise AssertionError("a per-layer path ran")

    monkeypatch.setattr(pna, "pna_local_model", counted)
    for name in ("pna_local_layer", "pna_local_stats_ell", "_aggregates"):
        monkeypatch.setattr(pna, name, other)
    batch = tb.to_device(_batches(window, big)["slot"], "cpu")
    p = tl.params_from_numpy(_params(), tn.FLOAT32, "cpu")
    for _ in range(2):
        out = pna.forward(p, batch, tn.FLOAT32)
        assert out.shape == (batch["n_node"].shape[0], 1) and bool(out[: SMALL + 1].isfinite().all())
    slots = batch["slot_geom"].shape[-1]
    assert calls == [(window, slots, tb.slot_prefix_caps(batch, slots))] * 2


def _stream(name: str, layout, window: int, **kw) -> list:
    """Three buckets of molhiv-shaped graphs in ``layout`` at ``window``, on
    the CPU."""
    graphs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(30, seed=9))
    buckets = list(tg.pack_dataset(graphs, node_capacity=255, edge_capacity=1024,
                                   graph_capacity=12, align_window=window))
    assert len(buckets) >= 3
    return [tb.to_device(b, "cpu") for b in tb.as_batches_uniform(
        buckets, blocked=layout, window=window, **kw)]


@pytest.mark.parametrize("name", ["pna", "gcn"], ids=["row3", "row9"])
def test_rows_3_9_tiles_packed_once_per_weight_set(name, monkeypatch):
    """The bf16 weight chunks of row 3 (PNA's towers over a slot stream) and
    row 9 (GCN's next convs over an ELL stream): one pack for a forward over
    several buckets, the same tensor in every launch's operands; f32 packs
    none; an in-place update of the weights packs again, and the new chunks
    hold the new weights."""
    packs = []
    real = local_layer.linear_tiles

    def counted(wt, n):
        packs.append(tuple(wt.shape))
        return real(wt, n)

    monkeypatch.setattr(local_layer, "linear_tiles", counted)
    local_layer._MLP_TILES.clear()
    if name == "pna":
        params = tl.params_from_numpy(tl.synthetic_pna_params(6, dim=D, layers=3), tn.BF16, "cpu")
        batches, model, key = _stream("pna", "local_slots", 128), pna, "tower_tiles"
        operands, tiles_of = model.slot_kernel_operands, lambda: pna.tower_tiles(params, tn.BF16)
    else:
        params = tl.params_from_numpy(tl.synthetic_gcn_params(6, dim=D, layers=3), tn.BF16, "cpu")
        batches, model, key = _stream("gcn", "local_ell", 128, block=384), gcn, "conv_tiles"
        operands, tiles_of = model.ell_kernel_operands, lambda: gcn.conv_tiles(params, tn.BF16)
    forward_all = lambda: [model.forward(params, b, tn.BF16) for b in batches]
    first = forward_all()
    assert len(packs) == 1
    tiles = tiles_of()
    assert all(operands(params, b, tn.BF16)[key] is tiles for b in batches)
    assert operands(params, batches[0], tn.FLOAT32)[key] is None
    assert len(packs) == 1

    with torch.no_grad():
        params["conv_w"][-1].mul_(2)
    again = forward_all()
    assert len(packs) == 2
    new = tiles_of()
    assert new is not tiles and not torch.equal(new, tiles)
    assert torch.equal(new[:-1], tiles[:-1])  # only the last layer's chunks moved
    assert any(not torch.equal(a, b) for a, b in zip(first, again))
    assert len(packs) == 2
