"""The port's native host packer (``flowgnn_tpu_torch/runtime/packer.cc``
through ``runtime.native``) and its dataset reader and writer
(``core.io``), against the port's numpy code and the JAX package's: the
bucket packer aligned and unaligned, a partial pack included, byte-equal to
both numpy packers; the ELL builder lane for lane equal to the numpy loop at
W=128 and W=512 with a 400-node graph and a spill tail; the graph reader on
what ``core.io.write_dataset`` writes, equal to both packages' ``read_graph``;
the self-loop and virtual-node transforms; a failed build that raises; node
ids outside their graph that raise before they reach the library; the
weight chunks ``ops.local_layer.hold_packs``
keeps past the chunk cache's eviction."""

import dataclasses

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import blocking as jblocking
from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import io as jio
from flowgnn_tpu_torch.core import blocking, io
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_molhiv
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.runtime import native

FIELDS = ("node_feat", "node_graph", "senders", "receivers", "edge_attr", "n_node", "n_edge")


@pytest.fixture(scope="module")
def graphs():
    return synthetic_molhiv(16, seed=7)


def _jax(gs):
    return [jg.Graph(g.node_feat, g.edge_index, g.edge_attr) for g in gs]


def _assert_packed_equal(got, want, what: str) -> None:
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == np.int32 and a.shape == b.shape, (what, field)
        assert a.tobytes() == np.ascontiguousarray(b, np.int32).tobytes(), (what, field)


@pytest.mark.parametrize("window", [0, 64, 128], ids=["unaligned", "W64", "W128"])
def test_pack_bucket_matches_numpy_packers(graphs, window):
    """``pack_bucket_native`` is byte for byte the port's numpy packer and
    the JAX package's (``pack_graphs`` unaligned, ``pack_graphs_aligned``
    at a window) on 16 molhiv-shaped graphs."""
    caps = (1023, 2048, 16)
    got, consumed = native.pack_bucket_native(graphs, *caps, window=window)
    assert consumed == 16
    if window:
        want = tg.pack_graphs_aligned(graphs, *caps, window=window)
        jwant = jg.pack_graphs_aligned(_jax(graphs), *caps, window=window)
    else:
        want, jwant = tg.pack_graphs(graphs, *caps), jg.pack_graphs(_jax(graphs), *caps)
    _assert_packed_equal(got, want, "port")
    _assert_packed_equal(got, jwant, "jax")


@pytest.mark.parametrize("window", [0, 128], ids=["unaligned", "W128"])
def test_pack_bucket_partial(graphs, window):
    """A bucket too small for all graphs takes a prefix and says how many:
    that prefix packed by either numpy packer, byte for byte; a first graph
    larger than the bucket raises."""
    caps = (255, 512, 16)
    got, consumed = native.pack_bucket_native(graphs, *caps, window=window)
    assert 1 <= consumed < 16
    prefix = graphs[:consumed]
    if window:
        want = tg.pack_graphs_aligned(prefix, *caps, window=window)
        jwant = jg.pack_graphs_aligned(_jax(prefix), *caps, window=window)
        with pytest.raises(ValueError):  # the next graph does not fit
            tg.pack_graphs_aligned(graphs[:consumed + 1], *caps, window=window)
    else:
        want, jwant = tg.pack_graphs(prefix, *caps), jg.pack_graphs(_jax(prefix), *caps)
    _assert_packed_equal(got, want, "port")
    _assert_packed_equal(got, jwant, "jax")
    with pytest.raises(ValueError):
        native.pack_bucket_native(graphs, 4, 512, 16, window=window)


def test_pack_dataset_native_streams_every_graph(graphs):
    buckets = list(native.pack_dataset_native(graphs, 128, 512, 8))
    assert len(buckets) > 2
    assert sum(b.num_graphs for b in buckets) == 16
    i = 0
    for b in buckets:
        k = b.num_graphs
        _assert_packed_equal(b, tg.pack_graphs(graphs[i:i + k], 128, 512, 8), f"bucket at {i}")
        i += k


def _ell_packing(window: int, seed: int):
    """Molhiv-shaped graphs and one of 400 nodes, packed window-aligned: the
    large graph's window-crossing edges and the dense windows' overflow
    ride the spill tail."""
    rng = np.random.default_rng(seed)
    gs = synthetic_molhiv(12, seed=seed) + [random_molecule_graph(rng, num_nodes=400)]
    return tg.pack_graphs_aligned(gs, node_capacity=2047, edge_capacity=4096,
                                  graph_capacity=16, window=window)


@pytest.mark.parametrize("window,block,k,spill", [
    (128, 384, None, True), (128, 128, 1, True), (128, 128, None, True),
    (512, 1536, None, False), (512, 512, 1, True), (512, 256, 2, True)])
def test_local_ell_matches_numpy_loop(window, block, k, spill, monkeypatch):
    """``build_local_ell_native`` equals the numpy loop lane for lane (the
    auto k from the 95th percentile, the spill order: crossing edges, then
    each window's overflow); ``build_local_blocks_ell`` (which takes the
    native lanes) gives the JAX package's numpy builder's ``LocalBlocks``. At
    W=128 the 400-node graph crosses windows; at W=512 it fits one, and its
    window's lanes overflow a block of 512 or 256."""
    packed = _ell_packing(window, seed=3)
    n = packed.node_capacity + 1
    got = native.build_local_ell_native(packed.senders, packed.receivers, n, window, block, k)
    want = blocking._local_ell_lanes(packed.senders, packed.receivers, n, window, block, k)
    assert got[5] == want[5]
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got[4].size > 0) == spill  # the spill tail
    lb = blocking.build_local_blocks_ell(packed.senders, packed.receivers, n, window, block, k)
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")  # the JAX package's numpy builder
    jlb = jblocking.build_local_blocks_ell(packed.senders, packed.receivers, n, window=window,
                                           block=block, k_blocks=k)
    for f in dataclasses.fields(lb):
        a, b = getattr(lb, f.name), getattr(jlb, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name


def test_read_graph_native_reads_what_io_writes(graphs, tmp_path):
    """``read_graph_native`` on a dataset ``core.io.write_dataset`` wrote
    equals the port's and the JAX package's ``read_graph`` and the graphs
    written; the eigenvector files round-trip through both packages."""
    gs = tg.laplacian_eigenvectors(graphs[0]), graphs[1], dataclasses.replace(
        graphs[2], edge_attr=None)
    io.write_dataset(str(tmp_path), gs)
    assert [g.num_nodes for g in io.read_dataset(str(tmp_path))] == [g.num_nodes for g in gs]
    for i, g in enumerate(gs, start=1):
        with_attr = g.edge_attr is not None
        got = native.read_graph_native(str(tmp_path), i, with_attr=with_attr)
        port = io.read_graph(str(tmp_path), i, with_eigen=g.node_eigen is not None)
        jax = jio.read_graph(str(tmp_path), i, with_eigen=g.node_eigen is not None)
        for want in (g, port, jax):
            assert np.array_equal(got.node_feat, want.node_feat)
            assert np.array_equal(got.edge_index, want.edge_index)
            assert (got.edge_attr is None) == (want.edge_attr is None)
            if with_attr:
                assert np.array_equal(got.edge_attr, want.edge_attr)
        if g.node_eigen is not None:
            assert np.allclose(port.node_eigen, g.node_eigen, atol=1e-4)
            assert np.array_equal(port.node_eigen, jax.node_eigen)
    with pytest.raises(FileNotFoundError):
        native.read_graph_native(str(tmp_path), 9)
    with pytest.raises(IOError):  # no edge_attr file for graph 3
        native.read_graph_native(str(tmp_path), 3, with_attr=True)


def test_graph_transforms_native(graphs):
    """``fg_add_self_loops`` is ``core.graphs.add_self_loops``;
    ``fg_add_virtual_node`` is the JAX package's materialized virtual node."""
    for g in graphs[:4]:
        got, want = native.add_self_loops_native(g), tg.add_self_loops(g)
        assert np.array_equal(got.edge_index, want.edge_index)
        assert np.array_equal(got.edge_attr, want.edge_attr)
        got, want = native.add_virtual_node_native(g), jg.add_virtual_node(_jax([g])[0])
        for field in ("node_feat", "edge_index", "edge_attr"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), field


def test_failed_build_raises(tmp_path, monkeypatch):
    """A native packer that does not build raises, in ``load_library`` and
    in the ELL layout that needs it: no quiet numpy fallback."""
    broken = tmp_path / "packer.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_library()
    packed = _ell_packing(128, seed=4)
    n = packed.node_capacity + 1
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        blocking.build_local_blocks_ell(packed.senders, packed.receivers, n, 128, 384)


@pytest.mark.parametrize("bad", [-1, 2048], ids=["negative", "past_the_pad"])
@pytest.mark.parametrize("end", ["senders", "receivers"])
@pytest.mark.parametrize("k", [None, 1], ids=["auto_k", "k1"])
def test_local_ell_rejects_node_ids_out_of_range(end, bad, k):
    """A sender or receiver below 0 or past the pad node raises
    ``ValueError`` in ``build_local_ell_native`` (and in
    ``build_local_blocks_ell``), before ``fg_build_local_ell`` could index
    its window counts with it; the library call itself also refuses it
    (returns -1, writing nothing)."""
    packed = _ell_packing(128, seed=5)
    n = packed.node_capacity + 1
    ids = {"senders": packed.senders.copy(), "receivers": packed.receivers.copy()}
    ids[end][3] = bad
    with pytest.raises(ValueError, match="outside"):
        native.build_local_ell_native(ids["senders"], ids["receivers"], n, 128, 384, k)
    with pytest.raises(ValueError, match="outside"):
        blocking.build_local_blocks_ell(ids["senders"], ids["receivers"], n, 128, 384, k)
    lib = native.load_library()
    s, r = (np.ascontiguousarray(ids[key], np.int32) for key in ("senders", "receivers"))
    k_io = native._I32(-1)
    assert lib.fg_build_local_ell(native._ptr(s), native._ptr(r), s.shape[0], n, 128, 384,
                                  native.ctypes.byref(k_io), None, None, None, None, None) == -1
    assert k_io.value == -1


@pytest.mark.parametrize("bad", [-1, 0], ids=["negative", "past_its_graph"])
def test_pack_bucket_rejects_edges_outside_their_graph(graphs, bad):
    """An edge whose end lies outside its own graph (below 0, or at or past
    the graph's node count) raises ``ValueError`` in ``pack_bucket_native``."""
    gs = list(graphs[:4])
    g = gs[2]
    edge_index = g.edge_index.copy()
    edge_index[0, 1] = bad if bad < 0 else g.num_nodes + bad
    gs[2] = dataclasses.replace(g, edge_index=edge_index)
    with pytest.raises(ValueError, match="outside its graph"):
        native.pack_bucket_native(gs, 1023, 2048, 16, window=128)


def test_hold_packs_outlives_the_chunk_cache():
    """More weight sets than the cache keeps (``MLP_TILE_SETS``): the cache
    evicts the oldest sets' chunks, and ``hold_packs`` still holds every
    tensor handed out in its block, each equal to a fresh pack, and a hit
    is held too."""
    rng = np.random.default_rng(0)
    n_sets = local_layer.MLP_TILE_SETS + 2
    sets = [(torch.from_numpy(rng.normal(size=(2 * 32, 16)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2 * 16, 32)).astype(np.float32)))
            for _ in range(n_sets)]
    held: list = []
    with local_layer.hold_packs(held):
        tiles = [local_layer.mlp_tiles(w1, w2, 2) for w1, w2 in sets]
        hit = local_layer.mlp_tiles(*sets[-1], 2)
    assert hit is tiles[-1]
    assert len(held) == n_sets + 1 and all(a is b for a, b in zip(held, tiles + [hit]))
    cached = {id(v[0]) for v in local_layer._MLP_TILES.values()}
    assert id(tiles[0]) not in cached and id(tiles[-1]) in cached
    for (w1, w2), t in zip(sets, held):
        assert torch.equal(t, local_layer.gin_mlp_tiles(w1, w2, 2))
    assert local_layer._HELD == []
    local_layer.mlp_tiles(*sets[0], 2)
    assert len(held) == n_sets + 1  # nothing collected outside the block
