"""PNA and DGN over slot batches that their whole-model kernels (rows 3 and
4) do not take, which run one layer per launch through rows 20
(``pna_local_layer``) and 22 (``dgn_local_layer_slots``), the one-layer
forms of rows 3 and 4 on a thread-block cluster of W/128 blocks: at W=256
and W=512, at a small width (D=16, L=2), the per-layer slot path with
``return_intermediates`` against the JAX forward (its Pallas kernels in
interpret mode) in every intermediate, DGN also on a W=256 bucket with a
spill tail (a graph that crosses windows and hub nodes past the 8 slots);
the routing of such batches to rows 20 and 22, one launch a layer; and
their bf16 weight chunks, packed once per weight set for all layers and
handed out layer by layer, again after an in-place update of the
weights."""

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
from flowgnn_tpu_torch.core.features import BOND_FEATURE_DIMS
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import dgn, gcn, pna
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders as tl

D, L = 16, 2
SMALL = 6  # molhiv-shaped graphs beside the large ones
HUB = 12  # in-window in-degree of the hub nodes: past the 8 slots
# (model, window, the large graph's nodes, whether the bucket spills): the
# window choose_geometry gives the large graph, or W=256 under a 300-node
# graph that crosses windows, beside one with hub nodes.
CASES = [("pna", 256, 250, False), ("pna", 512, 400, False),
         ("dgn", 256, 300, True), ("dgn", 512, 400, False)]
IDS = ["pna-W256", "pna-W512", "dgn-W256-spill", "dgn-W512"]
# Each model's per-layer slot kernel (row 20 or 22), DGN's per-layer ELL
# kernel (row 18), which takes row 22's posttrans chunks, and GCN's (row
# 15), which takes row 9's next-conv chunks.
ROWS = {"pna": (pna, "pna_local_layer", "tower_tiles", "conv_w"),
        "dgn": (dgn, "dgn_local_layer_slots", "posttrans_tiles", "posttrans_w"),
        "dgn-ell": (dgn, "dgn_local_layer_ell", "posttrans_tiles", "posttrans_w"),
        "gcn-ell": (gcn, "gcn_local_layer_ell", "conv_tiles", "conv_w")}


def _hub_arrays(big: int):
    """(node_feat, edge_index, edge_attr) of a ``big``-node molecule-shaped
    graph whose first three nodes each take ``HUB`` more bonds."""
    rng = np.random.default_rng(big + 7)
    g = ts.random_molecule_graph(rng, num_nodes=big)
    have = set(map(tuple, g.edge_index.tolist()))
    new = []
    for hub in range(3):
        free = [v for v in range(3, big) if (hub, v) not in have]
        for v in rng.choice(free, HUB, replace=False):
            new += [(hub, int(v)), (int(v), hub)]
    attr = np.stack([rng.integers(0, d, len(new) // 2) for d in BOND_FEATURE_DIMS], axis=1)
    return (g.node_feat, np.concatenate([g.edge_index, np.asarray(new, np.int32)]),
            np.concatenate([g.edge_attr, np.repeat(attr.astype(np.int32), 2, axis=0)]))


def _graphs(name: str, mod, big: int, spill: bool):
    """Six molhiv-shaped graphs and one of ``big`` nodes (with ``spill``,
    also a 120-node graph with hub nodes), through the model's transforms,
    from ``mod``'s host layer (the JAX package's or the port's)."""
    reg, graph = (jr, jg.Graph) if mod is js else (tr, tg.Graph)
    graphs = mod.synthetic_molhiv(SMALL, seed=8) + [
        mod.random_molecule_graph(np.random.default_rng(big + 1), num_nodes=big)]
    if spill:
        graphs.append(graph(*_hub_arrays(120)))
    return reg.apply_transforms(reg.get(name), graphs)


def _caps(name: str, window: int) -> dict:
    return dict(node_capacity=4 * window - 1, edge_capacity=4096, graph_capacity=16,
                with_eigen=name == "dgn")


def _batches(name: str, window: int, big: int, spill: bool) -> dict:
    """The slot batch at ``window`` from both packages and the port's plain
    edge-list batch of the same graphs; the number of real graphs."""
    jgs, tgs = _graphs(name, js, big, spill), _graphs(name, ts, big, spill)
    if not spill:
        assert tb.choose_geometry(name, max(g.num_nodes for g in tgs))[0] == window
    jp = jg.pack_graphs_aligned(jgs, window=window, **_caps(name, window))
    tp = tg.pack_graphs_aligned(tgs, window=window, **_caps(name, window))
    slot = tb.as_batch(tp, blocked="local_slots", window=window)
    assert slot["slot_geom"].shape[0] == window
    assert bool(slot["slot_spill_mask"].any()) == spill
    return dict(
        jax_slot=jb.as_batch(jp, blocked="local_slots", window=window),
        slot=tb.to_device(slot, "cpu"), graphs=len(tgs),
        plain=tb.to_device(tb.as_batch(tg.pack_graphs(tgs, **_caps(name, window))), "cpu"),
    )


def _params(name: str) -> dict:
    make = tl.synthetic_pna_params if name == "pna" else tl.synthetic_dgn_params
    return make(5, dim=D, layers=L)


def _close(got, want, tol: float) -> None:
    """|got − want| ≤ tol·(scale + |want|), scale the largest |want| (at
    least 1): the layers' h reach tens where the predictions stay below 1."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,window,big,spill", CASES, ids=IDS)
def test_layer_slot_path_matches_jax(name, window, big, spill, monkeypatch):
    """The per-layer slot path with ``return_intermediates`` (rows 20 and
    22's plain versions; DGN's spill tail through row 24's) against the JAX
    forward on the same graphs (``pna_local_layer`` / ``dgn_local_layer_slots``
    in interpret mode), f32 to 1e-5 of each output's scale: the predictions,
    every layer's h and the pooled h; and the predictions against the port's
    plain edge-list path (1e-5; DGN's cancelling channel, 1e-4 of the largest
    prediction)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    b = _batches(name, window, big, spill)
    g = b["graphs"]
    p32 = tl.params_from_numpy(_params(name), tn.FLOAT32, "cpu")
    out, inter = tr.get(name).forward(p32, b["slot"], tn.FLOAT32, return_intermediates=True)
    want, want_inter = jr.get(name).forward(jb.prepare_params(_params(name), jn.FLOAT32),
                                            b["jax_slot"], jn.FLOAT32, return_intermediates=True)
    want = np.asarray(want)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert np.ptp(want[:g]) > 1e-4 and np.isfinite(want[:g]).all()
    _close(out[:g].numpy(), want[:g], 1e-5)
    assert len(inter["layers"]) == len(want_inter["layers"]) == L + 1
    for got_l, want_l in zip(inter["layers"], want_inter["layers"]):
        _close(got_l.numpy(), np.asarray(want_l), 1e-5)
    _close(inter["h_graph"][:g].numpy(), np.asarray(want_inter["h_graph"])[:g], 1e-5)
    plain = tr.get(name).forward(p32, b["plain"], tn.FLOAT32)
    tol = 1e-4 * max(1.0, float(np.abs(want[:g]).max())) if name == "dgn" else 1e-5
    np.testing.assert_allclose(out[:g].numpy(), plain[:g].numpy(), rtol=1e-5, atol=tol)


@pytest.mark.parametrize("name,window,big,spill", CASES, ids=IDS)
def test_layer_slot_path_routes_to_rows_20_22(name, window, big, spill, monkeypatch):
    """A slot batch run with ``return_intermediates`` (and DGN's spilling
    one, with or without) goes to row 20 or 22 once per layer, at the
    batch's window and slot depth, with the spill tail's channels where the
    bucket has one; never to the whole-model kernel, row 19 or the plain
    loop. In f32 no weight chunks are handed over."""
    mod, kernel = ROWS[name][:2]
    calls = []

    def counted(**ops):
        calls.append((ops["window"], ops["slots"], ops.get("m_spill") is not None,
                       ops[ROWS[name][2]] is None))
        return getattr(local_layer, kernel)(**ops)

    def other(*args, **kw):
        raise AssertionError("another path ran")

    monkeypatch.setattr(mod, kernel, counted)
    others = {"pna": ("pna_local_model", "pna_local_stats_ell", "_aggregates"),
              "dgn": ("dgn_local_model", "dgn_local_layer_ell", "edge_segment_sum")}[name]
    for k in others:
        monkeypatch.setattr(mod, k, other)
    batch = _batches(name, window, big, spill)["slot"]
    p = tl.params_from_numpy(_params(name), tn.FLOAT32, "cpu")
    out, _ = mod.forward(p, batch, tn.FLOAT32, return_intermediates=True)
    assert bool(out.isfinite().all())
    slots = int(batch["slot_geom"].shape[-1])
    assert calls == [(window, slots, spill, True)] * L
    if spill:  # the spill tail takes the per-layer path without intermediates too
        calls.clear()
        mod.forward(p, batch, tn.FLOAT32)
        assert calls == [(window, slots, True, True)] * L


def _stream(name: str, window: int, layout: str = "local_slots") -> list:
    """Three buckets of molhiv-shaped graphs in the slot layout (or ELL,
    blocks of 4W lanes: no spill tail) at ``window``, on the CPU."""
    graphs = tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(30, seed=9))
    buckets = list(tg.pack_dataset(graphs, node_capacity=255, edge_capacity=1024,
                                   graph_capacity=12, align_window=window,
                                   with_eigen=name == "dgn"))
    assert len(buckets) >= 3
    block = 4 * window if layout == "local_ell" else None
    return [tb.to_device(b, "cpu") for b in tb.as_batches_uniform(
        buckets, blocked=layout, window=window, block=block)]


@pytest.mark.parametrize("name", ["pna", "dgn", "dgn-ell", "gcn-ell"],
                         ids=["row20", "row22", "row18", "row15"])
def test_rows_20_22_tiles_packed_once_per_weight_set(name, monkeypatch):
    """The bf16 weight chunks of rows 20, 22, 18 (DGN's ELL path) and 15
    (GCN's) over a forward with intermediates across several buckets: one
    pack of every layer's chunks for the whole stream, each launch handed
    its layer's slice of them (a view, not a copy); an in-place update of
    the weights packs again, and only the updated layer's chunks move. Row
    18 takes row 22's chunks: the slot path on the same weights packs
    nothing more. Row 15 takes row 9's: the next convs of layers 1..L-1,
    layer l's launch handed the slice of conv l + 1 (the last layer, which
    has none, nothing), and row 9's operands on the same weights pack
    nothing more."""
    packs = []
    real = local_layer.linear_tiles

    def counted_pack(wt, n):
        packs.append(tuple(wt.shape))
        return real(wt, n)

    mod, kernel, key, weight = ROWS[name]
    handed = []

    def counted(**ops):
        handed.append(ops[key])
        return getattr(local_layer, kernel)(**ops)

    monkeypatch.setattr(local_layer, "linear_tiles", counted_pack)
    monkeypatch.setattr(mod, kernel, counted)
    local_layer._MLP_TILES.clear()
    gcn_ell = name == "gcn-ell"
    make = {"pna": tl.synthetic_pna_params, "gcn-ell": tl.synthetic_gcn_params}.get(
        name, tl.synthetic_dgn_params)
    params = tl.params_from_numpy(make(6, dim=D, layers=3), tn.BF16, "cpu")
    tiles_of = lambda: {"pna": pna.tower_tiles, "gcn-ell": gcn.conv_tiles}.get(
        name, dgn.posttrans_tiles)(params, tn.BF16)
    ell = name.endswith("-ell")
    model = name.split("-")[0]
    batches = _stream(model, 128, "local_ell" if ell else "local_slots")
    if ell:
        assert all(tb.ell_spill(b) is None for b in batches)  # rows 18 / 15, not 16 / 14 + 24
    forward_all = lambda: [mod.forward(params, b, tn.BF16, return_intermediates=True)[0]
                           for b in batches]
    # Layer l's launch takes chunk set l (GCN: the next conv's, none on the last layer).
    slice_of = lambda i, tiles: None if gcn_ell and i % 3 == 2 else tiles[i % 3]
    first = forward_all()
    assert len(packs) == 1 and packs[0][0] == (2 if gcn_ell else 3)  # all layers at once
    tiles = tiles_of()
    assert len(handed) == 3 * len(batches)
    for i, t in enumerate(handed):
        want = slice_of(i, tiles)
        assert t is None if want is None else (t.data_ptr() == want.data_ptr()
                                               and torch.equal(t, want))
    assert len(packs) == 1
    if name == "dgn-ell":  # row 22 on the same weights takes the same chunks
        slot_ops = dgn.layer_kernel_operands(params, _stream("dgn", 128)[0], tn.BF16)
        got = slot_ops["dgn_local_layer_slots"]["posttrans_tiles"]
        assert got.data_ptr() == tiles[0].data_ptr() and len(packs) == 1
    if gcn_ell:  # row 9 on the same weights takes the same chunks
        got = gcn.ell_kernel_operands(params, batches[0], tn.BF16)["conv_tiles"]
        assert got.data_ptr() == tiles.data_ptr() and len(packs) == 1

    with torch.no_grad():
        params[weight][-1].mul_(2)
    handed.clear()
    again = forward_all()
    assert len(packs) == 2
    new = tiles_of()
    assert new is not tiles and not torch.equal(new, tiles)
    assert torch.equal(new[:-1], tiles[:-1])  # only the last layer's chunks moved
    assert all(t is None if slice_of(i, new) is None else t.data_ptr() == slice_of(i, new).data_ptr()
               for i, t in enumerate(handed))
    assert any(not torch.equal(a, b) for a, b in zip(first, again))
    assert len(packs) == 2


@pytest.mark.parametrize("kernel,name,window", [
    ("pna_local_model", "pna", None), ("pna_local_layer", "pna", None),
    ("dgn_local_model", "dgn", None), ("dgn_local_layer_slots", "dgn", 128),
    ("gin_local_model", "gin", None), ("gcn_local_model", "gcn", None),
    ("gcn_local_model_slots", "gcn", None), ("gat_local_message_slots", "gat", None),
    ("gat_local_message_slots", "gat", 128)])
def test_slot_kernels_tool_launches_what_the_paths_launch(kernel, name, window):
    """``bench.slot_kernels`` times each kernel on the launches its path
    makes: a whole-model kernel once per bucket (rows 8 and 9 over ELL, row 2
    over slots),
    rows 20, 22 and 21 on each bucket's layer-0 operands once per layer (the
    spilling W=128 stream's with the tail's channels, row 21's as raw sums;
    row 21's molhiv stream's divided in the kernel); every launch's operands
    are ones the kernel's plain version takes."""
    from flowgnn_tpu_torch.bench import slot_kernels

    profile = "hep10k" if window else "molhiv"
    layout = (slot_kernels.ELL if kernel in ("gin_local_model", "gcn_local_model")
              else slot_kernels.SLOTS)
    assert (kernel, name, profile, layout, window) in {c[:3] + c[4:] for c in slot_kernels.CELLS}
    batches = slot_kernels.stream(name, profile, 60, layout, window, "cpu")
    ops = slot_kernels.calls(kernel, name, batches, layout, tn.FLOAT32, "cpu")
    per_bucket = tr.get(name).num_layers if kernel in slot_kernels.LAYER_KERNELS else 1
    assert len(ops) == per_bucket * len(batches)
    if window:
        assert all(bool(b["slot_spill_mask"].any()) for b in batches)
        assert all(o["m_spill"] is not None for o in ops) if name == "dgn" else all(
            not o["divide"] for o in ops)
    elif name == "gat":
        assert all(o["divide"] for o in ops)
    out = getattr(local_layer, f"{kernel}_ref")(**ops[-1])
    assert bool(out.isfinite().all())
