"""GCN, DGN and GAT over slot batches at windows above 128, which rows 2
(``gcn_local_model_slots``), 4 (``dgn_local_model``) and 5
(``gat_local_model_slots``) take on a thread-block cluster of W/128 blocks:
at W=256 and W=512, a few molhiv-shaped graphs and one large graph whose
slot sources cross block 0, at a small width, the port's slot layout
against the JAX package's key by key, each row's plain version against the
Pallas kernel in interpret mode, the forward against the JAX forward and the
port's plain path, and the forward's routing to its row. Then the bf16
weight chunks of rows 2, 4 and 5, packed once per weight set over a forward
of several buckets and again after an in-place update of the weights."""

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
from flowgnn_tpu_torch.models import dgn, gat, gcn
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders as tl
from test_torch_cuda import _gat_score_maps, _port
from test_torch_host import _assert_batches_equal
from test_torch_local_layer import _JAX_FORMS, _jax_kernel

D, L = 16, 2
GAT_HEADS, GAT_D, GAT_L = 2, 16, 3  # GAT at 2 heads × 16 (a head holds the 9 raw features)
GAT_HD = GAT_HEADS * GAT_D
T_OUT = 8  # readout MLP-1 width of DGN's operands
SMALL = 6  # molhiv-shaped graphs beside the large one
# (window, the large graph's nodes): the window choose_geometry gives it.
CASES = [(256, 250), (512, 400)]
IDS = [f"W{w}" for w, _ in CASES]
NAMES = ["gcn", "dgn", "gat"]
# Each model's row: its module and whole-model slot kernel.
ROWS = {"gcn": (gcn, "gcn_local_model_slots"), "dgn": (dgn, "dgn_local_model"),
        "gat": (gat, "gat_local_model_slots")}


def _graphs(name: str, mod, big: int):
    """Six molhiv-shaped graphs and one of ``big`` nodes, through the model's
    transforms (GAT's self loops, DGN's eigenvectors), from ``mod``'s host
    layer (the JAX package's or the port's)."""
    reg = jr if mod is js else tr
    graphs = mod.synthetic_molhiv(SMALL, seed=8) + [
        mod.random_molecule_graph(np.random.default_rng(big + 1), num_nodes=big)]
    return reg.apply_transforms(reg.get(name), graphs)


def _caps(name: str, window: int) -> dict:
    return dict(node_capacity=2 * window - 1, edge_capacity=4096, graph_capacity=16,
                with_eigen=name == "dgn")


def _batches(name: str, window: int, big: int) -> dict:
    """The slot batch at ``window`` from both packages and the port's plain
    edge-list batch of the same graphs."""
    jgs, tgs = _graphs(name, js, big), _graphs(name, ts, big)
    assert tb.choose_geometry(name, max(g.num_nodes for g in tgs))[0] == window
    jp = jg.pack_graphs_aligned(jgs, window=window, **_caps(name, window))
    tp = tg.pack_graphs_aligned(tgs, window=window, **_caps(name, window))
    return dict(
        jax_slot=jb.as_batch(jp, blocked="local_slots", window=window),
        slot=tb.as_batch(tp, blocked="local_slots", window=window),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **_caps(name, window))), "cpu"),
    )


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_slot_layout_above_128_equals_jax(name, window, big, monkeypatch):
    """The slot layout at W=256 and W=512 equals the JAX package's key by
    key; no edge spills, and the pooling layout is there, so the bucket is
    one the model's whole-model kernel takes; the large graph's slot
    sources lie past block 0."""
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    b = _batches(name, window, big)
    # The JAX package keeps the slot stacks in a float dtype for its TPU
    # gather, the port as int32: the same indices.
    jax_slot = dict(b["jax_slot"])
    for k in ("slot_stack", "slot_pstack"):
        stack = np.asarray(jax_slot[k])
        assert np.array_equal(stack.astype(np.int64), b["slot"][k]), k
        jax_slot[k] = stack.astype(np.int32)
    _assert_batches_equal(jax_slot, b["slot"])
    slot = b["slot"]
    assert slot["slot_geom"].shape[0] == window and "pool_gl" in slot and "slot_meta" in slot
    assert not slot["slot_spill"].shape[-1] and not slot["slot_spill_mask"].any()
    src = slot["slot_src"]
    assert ((src >= 0) & (src <= window)).all() and ((src >= 128) & (src < window)).any()


def _slot_operands(name: str, window: int, big: int, seed: int = 33) -> dict:
    """The row's operands on the slot batch: the layout's own degree and
    eigenvector terms, seeded random h0 and weights, as numpy arrays."""
    batch = _batches(name, window, big)["slot"]
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sd=0.2: rng.normal(0, sd, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    geom = dict(window=window, slots=slots, gmax=tb.POOL_GMAX,
                prefix_caps=tb.slot_prefix_caps(batch, slots))
    if name == "gcn":
        return dict(
            geom, slot_meta=batch["slot_meta"], h0=f32(n, D),
            dis=(1 / np.sqrt(batch["out_deg"] + 1.0)).astype(np.float32),
            pool_gl=batch["pool_gl"], ee_tables=f32(L * 13, D),
            roots=f32(L, D), alphas=(1 + f32(L, D)).astype(np.float32), betas=f32(L, D),
            wn_all=f32((L - 1) * D, D), bn_all=f32(L - 1, D), pred_w=f32(D, 1), num_layers=L,
        )
    if name == "dgn":
        abssum = batch["eig_abssum"]
        return dict(
            geom, slot_src=batch["slot_src"], h0=f32(n, D, sd=0.1),
            eig=batch["node_eigen"][:, 1].copy(),
            inv_deg=(1 / np.maximum(batch["out_deg"], 1)).astype(np.float32),
            eigw_sum=batch["eigw_sum"],
            inv_abssum=(1 / np.where(abssum == 0, dgn.EIG_EPS, abssum)).astype(np.float32),
            w_all=f32(L * 2 * D, D, sd=0.1), b_all=f32(L, D, sd=0.1), pool_gl=batch["pool_gl"],
            mlp1_w=f32(D, T_OUT, sd=0.1), num_layers=L,
        )
    hd = GAT_HD
    return dict(
        geom, slot_pstack=batch["slot_pstack"], h0=f32(n, hd, sd=0.3), skip0=f32(n, hd, sd=0.3),
        proj_w=f32((GAT_L - 1) * hd, hd, sd=0.3), skip_w=f32((GAT_L - 1) * hd, hd, sd=0.3),
        a_all=_gat_score_maps(f32(GAT_L, GAT_HEADS, GAT_D, sd=0.3),
                              f32(GAT_L, GAT_HEADS, GAT_D, sd=0.3)),
        pool_gl=batch["pool_gl"], pred_hd=f32(hd, 1, sd=0.3), num_heads=GAT_HEADS,
        num_layers=GAT_L,
    )


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_plain_version_above_128_matches_jax(name, window, big, monkeypatch):
    """Rows 2, 4 and 5's plain versions against the Pallas kernels in
    interpret mode (GAT's against ``gat_local_model_pairs``, the JAX
    default) at W=256 and W=512, f32 to 1e-5 of the output's scale: the
    large graph's rows and their slot sources span two and four of the
    kernels' 128-row blocks, and its pool sums 250-400 rows in another order
    than the Pallas kernels' one-hot product."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    kernel = ROWS[name][1]
    ops = _slot_operands(name, window, big)
    jax_name, convert = _JAX_FORMS.get(kernel, (kernel, dict))
    expect = _jax_kernel(jax_name, convert(ops))
    got = getattr(local_layer, kernel)(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    scale = np.abs(expect).max()
    assert scale > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


def _params(name: str) -> dict:
    if name == "gcn":
        return tl.synthetic_gcn_params(5, dim=D, layers=L)
    if name == "dgn":
        return tl.synthetic_dgn_params(5, dim=D, layers=L)
    return tl.synthetic_gat_params(5, dim=GAT_D, heads=GAT_HEADS, layers=GAT_L)


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_forward_on_slots_above_128_matches_jax(name, window, big, monkeypatch):
    """The forward over the W=256 / W=512 slot batch (the row's plain
    version) against the JAX forward (its slot kernel in interpret mode),
    f32 to 1e-5 as the models' own tests hold W=128; and against the port's
    own plain edge-list path (1e-5; DGN's cancelling channel, 1e-4 of the
    largest prediction)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    b = _batches(name, window, big)
    p32 = tl.params_from_numpy(_params(name), tn.FLOAT32, "cpu")
    got = tr.get(name).forward(p32, tb.to_device(b["slot"], "cpu"), tn.FLOAT32)
    expect = np.asarray(jr.get(name).forward(jb.prepare_params(_params(name), jn.FLOAT32),
                                             b["jax_slot"], jn.FLOAT32))
    g = SMALL + 1
    assert got.dtype == torch.float32 and got.shape == expect.shape
    scale = np.abs(expect[:g]).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got[:g].numpy(), expect[:g], rtol=1e-5, atol=1e-5)
    plain = tr.get(name).forward(p32, b["plain"], tn.FLOAT32)
    tol = 1e-4 * max(1.0, scale) if name == "dgn" else 1e-5
    np.testing.assert_allclose(got[:g].numpy(), plain[:g].numpy(), rtol=1e-5, atol=tol)


# Each model's per-layer slot kernels and plain-loop helpers, none of which
# a slot batch with no spill tail and the pooling layout may reach.
OTHER_PATHS = {"gcn": ("gcn_local_model", "gcn_local_layer_ell", "gcn_local_message_ell",
                       "edge_segment_sum"),
               "dgn": ("dgn_local_layer_slots", "dgn_local_layer_ell", "dgn_local_message_ell",
                       "edge_segment_sum"),
               "gat": ("gat_local_message_slots", "gat_local_message_ell", "gat_local_layer_ell",
                       "edge_segment_sum")}


@pytest.mark.parametrize("window,big", CASES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_forward_routes_slots_above_128_to_its_row(name, window, big, monkeypatch):
    """The forward sends a W=256 / W=512 slot batch with no spill tail and
    the pooling layout to its whole-model kernel (row 2, 4 or 5), one call
    per forward with the batch's window and slot geometry, and to no
    per-layer kernel nor the plain loop."""
    module, kernel = ROWS[name]
    calls = []
    real = getattr(local_layer, kernel)

    def counted(**ops):
        calls.append((ops["window"], ops["slots"], ops["prefix_caps"]))
        return real(**ops)

    def other(*args, **kw):
        raise AssertionError("another path ran")

    monkeypatch.setattr(module, kernel, counted)
    for attr in OTHER_PATHS[name]:
        monkeypatch.setattr(module, attr, other)
    batch = tb.to_device(_batches(name, window, big)["slot"], "cpu")
    p = tl.params_from_numpy(_params(name), tn.FLOAT32, "cpu")
    for _ in range(2):
        out = module.forward(p, batch, tn.FLOAT32)
        assert out.shape == (batch["n_node"].shape[0], 1) and bool(out[: SMALL + 1].isfinite().all())
    slots = batch["slot_geom"].shape[-1]
    assert calls == [(window, slots, tb.slot_prefix_caps(batch, slots))] * 2


def _stream(name: str, window: int) -> list:
    """Three slot buckets of molhiv-shaped graphs at ``window``, on the CPU."""
    graphs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(30, seed=9))
    buckets = list(tg.pack_dataset(graphs, node_capacity=255, edge_capacity=1024,
                                   graph_capacity=12, align_window=window,
                                   with_eigen=name == "dgn"))
    assert len(buckets) >= 3
    return [tb.to_device(b, "cpu") for b in tb.as_batches_uniform(
        buckets, blocked="local_slots", window=window)]


# Each row's packed weights: (the operand key, the model's tile function, the
# params key an in-place update touches).
TILES = {"gcn": ("conv_tiles", gcn.conv_tiles, "conv_w"),
         "dgn": ("posttrans_tiles", dgn.posttrans_tiles, "posttrans_w"),
         "gat": ("glue_tiles", gat.glue_tiles, "skip_w")}


@pytest.mark.parametrize("name", NAMES, ids=["row2", "row4", "row5"])
def test_rows_2_4_5_tiles_packed_once_per_weight_set(name, monkeypatch):
    """The bf16 weight chunks of rows 2 (GCN's next convs), 4 (DGN's
    posttrans) and 5 (GAT's glue) over a slot stream: one pack for a forward
    over several buckets, the same tensor in every launch's operands; f32
    packs none; an in-place update of the weights packs again, and the new
    chunks hold the new weights."""
    packs = []
    real = local_layer.linear_tiles

    def counted(wt, n):
        packs.append(tuple(wt.shape))
        return real(wt, n)

    monkeypatch.setattr(local_layer, "linear_tiles", counted)
    local_layer._MLP_TILES.clear()
    module = ROWS[name][0]
    key, tiles_fn, weight = TILES[name]
    layers = 3
    if name == "gat":
        raw = tl.synthetic_gat_params(6, dim=GAT_D, heads=GAT_HEADS, layers=layers)
    else:
        raw = {"gcn": tl.synthetic_gcn_params, "dgn": tl.synthetic_dgn_params}[name](
            6, dim=D, layers=layers)
    params = tl.params_from_numpy(raw, tn.BF16, "cpu")
    batches = _stream(name, 128)
    forward_all = lambda: [module.forward(params, b, tn.BF16) for b in batches]
    first = forward_all()
    assert len(packs) == 1
    tiles = tiles_fn(params, tn.BF16)
    assert all(module.slot_kernel_operands(params, b, tn.BF16)[key] is tiles for b in batches)
    assert module.slot_kernel_operands(params, batches[0], tn.FLOAT32)[key] is None
    assert tiles_fn(params, tn.FLOAT32) is None
    assert len(packs) == 1

    with torch.no_grad():
        params[weight][-1].mul_(2)
    again = forward_all()
    assert len(packs) == 2
    new = tiles_fn(params, tn.BF16)
    assert new is not tiles and not torch.equal(new, tiles)
    assert torch.equal(new[:-1], tiles[:-1])  # only the last layer's chunks moved
    assert any(not torch.equal(a, b) for a, b in zip(first, again))
    assert len(packs) == 2
