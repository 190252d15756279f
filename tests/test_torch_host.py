"""The port's numpy host layer against the JAX package's: same graphs, same
packed buckets, same slot layouts (the JAX side stores some of them as
bfloat16, the port as int32; the values must be equal)."""

import numpy as np
import pytest

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr


def _assert_graphs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.node_feat, y.node_feat)
        assert np.array_equal(x.edge_index, y.edge_index)
        assert np.array_equal(x.edge_attr, y.edge_attr)
        for f in ("node_eigen", "node_vn"):
            a, b = getattr(x, f), getattr(y, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f


def _assert_batches_equal(jax_batch: dict, port_batch: dict):
    """Equal keys, shapes and values; the port's own marker of the spill
    tail's compact window count T must equal the count the JAX package
    reads off ``spill_blk_window``."""
    port_batch = dict(port_batch)
    if "spill_blk_window" in jax_batch:
        t = int(np.asarray(jax_batch["spill_blk_window"]).max()) + 1
        assert port_batch.pop("spill_blk_compact").shape == (t,)
    assert set(jax_batch) == set(port_batch)
    for k, v in jax_batch.items():
        a = np.asarray(v).astype(np.float64)  # bf16 upcasts exactly
        b = np.asarray(port_batch[k]).astype(np.float64)
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), k
        if np.asarray(v).dtype == np.float32:  # eigenvectors and their sums
            assert np.asarray(port_batch[k]).dtype == np.float32, k


def test_synthetic_streams_equal():
    _assert_graphs_equal(js.synthetic_molhiv(8, seed=3), ts.synthetic_molhiv(8, seed=3))
    _assert_graphs_equal(
        js.synthetic_dataset("molhiv", seed=0, num_graphs=64),
        ts.synthetic_dataset("molhiv", seed=0, num_graphs=64),
    )


@pytest.mark.parametrize("name", ["gin", "gin-vn", "dgn", "gat"])
def test_packing_and_slot_layouts_equal(name):
    """DGN's eigenvectors (with their per-node eig sums) and GAT's self
    loops, first in each graph's edge list, come out equal too."""
    jspec, tspec = jr.get(name), tr.get(name)
    assert tspec.needs_eigen == jspec.needs_eigen
    jgs = jr.apply_transforms(jspec, js.synthetic_dataset("molhiv", seed=5, num_graphs=40))
    tgs = tr.apply_transforms(tspec, ts.synthetic_dataset("molhiv", seed=5, num_graphs=40))
    _assert_graphs_equal(jgs, tgs)
    if name == "gat":  # one self edge per node, before the graph's own edges
        for g in tgs:
            loops = np.repeat(np.arange(g.num_nodes)[:, None], 2, axis=1)
            assert np.array_equal(g.edge_index[: g.num_nodes], loops)

    w = 128
    caps = dict(node_capacity=383, graph_capacity=16, with_eigen=jspec.needs_eigen)
    edge_cap = jg.auto_edge_capacity(jgs, caps["node_capacity"])
    assert tg.auto_edge_capacity(tgs, caps["node_capacity"]) == edge_cap
    jbuckets = list(jg.pack_dataset(jgs, edge_capacity=edge_cap, align_window=w, **caps))
    tbuckets = list(tg.pack_dataset(tgs, edge_capacity=edge_cap, align_window=w, **caps))
    assert len(jbuckets) == len(tbuckets) >= 3
    for a, b in zip(jbuckets, tbuckets):
        for f in ("node_feat", "node_graph", "senders", "receivers", "edge_attr",
                  "n_node", "n_edge", "node_eigen", "node_vn"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.array_equal(x, y), f

    small = dict(node_capacity=511, edge_capacity=2048, graph_capacity=16,
                 with_eigen=jspec.needs_eigen)
    _assert_batches_equal(
        jb.as_batch(jg.pack_graphs(jgs[:8], **small)),
        tb.as_batch(tg.pack_graphs(tgs[:8], **small)),
    )
    _assert_batches_equal(
        jb.as_batch(jg.pack_graphs_aligned(jgs[:8], window=w, **small),
                    blocked="local_slots", window=w),
        tb.as_batch(tg.pack_graphs_aligned(tgs[:8], window=w, **small),
                    blocked="local_slots", window=w),
    )

    jbatches = jb.as_batches_uniform(jbuckets, blocked="local_slots", window=w)
    tbatches = tb.as_batches_uniform(tbuckets, blocked="local_slots", window=w)
    assert len({tb.batch_signature(b) for b in tbatches}) == 1
    for a, b in zip(jbatches, tbatches):
        _assert_batches_equal(a, b)
        assert ("eigw_sum" in b) == jspec.needs_eigen
    # to_device keeps the marker shapes that carry static geometry.
    dev = tb.to_device(tbatches[0], "cpu")
    s = dev["slot_geom"].shape[-1]
    assert tuple(dev["slot_geom"].shape) == (w, s)
    assert tb.slot_prefix_caps(dev, s) == jb.slot_prefix_caps(jbatches[0], s)


def test_spill_and_unported_layouts_raise():
    """A graph larger than the window spills edges: the slot layout carries
    them in its blocked spill tail, equal to the JAX package's (a bucket of
    256 rows has no full scatter window of 512, so neither side attaches the
    gather-side blocks); so does the ELL layout, after its lanes (it raised
    before the per-layer ELL kernels were ported); so does the legacy
    dynamic-window layout, in its un-blocked tail of 8192 lanes (it raised
    before it was ported)."""
    caps = dict(window=128, node_capacity=255, edge_capacity=1024, graph_capacity=2)
    jpacked = jg.pack_graphs_aligned([js.random_molecule_graph(np.random.default_rng(0), num_nodes=150)], **caps)
    packed = tg.pack_graphs_aligned([ts.random_molecule_graph(np.random.default_rng(0), num_nodes=150)], **caps)
    slot = tb.as_batch(packed, blocked="local_slots", window=128)
    assert slot["slot_spill_mask"].any() and "spill_gblk_src" not in slot
    _assert_batches_equal(jb.as_batch(jpacked, blocked="local_slots", window=128), slot)
    ell = tb.as_batch(packed, blocked="local_ell", window=128, block=384)
    assert tb.ell_spill_lanes(ell) > 0 and "spill_gblk_src" not in ell
    _assert_batches_equal(jb.as_batch(jpacked, blocked="local_ell", window=128, block=384), ell)
    local = tb.as_batch(packed, blocked="local")
    p = local["loc_ulocal"].shape[0]
    assert (local["receivers"][p:] < 255).any() and local["senders"].shape[0] - p == 8192
    _assert_batches_equal(jb.as_batch(jpacked, blocked="local"), local)


def test_default_geometries():
    """Without a window, the ELL layout packs the JAX package's (512, 1536),
    where the port once packed (128, 384); the slot layout keeps W=128 where
    the JAX package packs 512, because the port's slot kernels refuse wider
    windows (the divergence ``as_batch`` states)."""
    caps = dict(window=512, node_capacity=1023, edge_capacity=4096, graph_capacity=16)
    jpacked = jg.pack_graphs_aligned(js.synthetic_molhiv(12, seed=4), **caps)
    packed = tg.pack_graphs_aligned(ts.synthetic_molhiv(12, seed=4), **caps)
    ell = tb.as_batch(packed, blocked="local_ell")
    assert tb.ell_geometry(ell) == (512, 1) and ell["loc_ulocal"].shape[0] == 2 * 1536
    assert tb.ELL_DEFAULT_GEOMETRY == (jb.PALLAS_ELL_WINDOW, jb.PALLAS_ELL_BLOCK)
    _assert_batches_equal(jb.as_batch(jpacked, blocked="local_ell"), ell)
    assert tb.as_batch(packed, blocked="local_slots")["slot_geom"].shape[0] == 128
    assert jb.as_batch(jpacked, blocked="local_slots")["slot_geom"].shape[0] == 512
