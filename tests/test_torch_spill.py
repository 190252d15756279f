"""The slot layout's spill tail and the per-layer slot kernels of PNA, DGN and
GAT, against the JAX package: the blocked spill layout key by key, each
kernel's plain version against its Pallas kernel in interpret mode, and the
models' forward on a slot batch whose tail is real (two graphs of 230 and
280 nodes span several windows of W=128), with GIN and GCN taking the plain
loop on such a batch as the JAX package does."""

import jax.numpy as jnp
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
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.ops import local_layer, spmm
from flowgnn_tpu_torch.params import loaders as tl

W = 128
CAPS = dict(node_capacity=1023, edge_capacity=4096, graph_capacity=16)
G = 12
BIG = (230, 280)  # nodes of the two graphs that span windows

SMALL_PARAMS = {
    "gin": lambda: tl.synthetic_gin_params(3, dim=16, hidden=32, layers=2),
    "gin-vn": lambda: tl.synthetic_gin_params(3, dim=16, hidden=32, layers=2),
    "gcn": lambda: tl.synthetic_gcn_params(3, dim=16, layers=2),
    "pna": lambda: tl.synthetic_pna_params(3, dim=16, layers=3),
    "dgn": lambda: tl.synthetic_dgn_params(3, dim=16, layers=3),
    "gat": lambda: tl.synthetic_gat_params(3, dim=16, heads=2, layers=3),
}


def _graphs(syn, seed: int = 4):
    rng = np.random.default_rng(seed)
    small = syn.synthetic_molhiv(G - len(BIG), seed=seed)
    return small[:5] + [syn.random_molecule_graph(rng, num_nodes=n) for n in BIG] + small[5:]


def _packed(name: str, seed: int = 4):
    """(JAX packing, port packing) of the graph set for model ``name``."""
    jspec, tspec = jr.get(name), tr.get(name)
    caps = dict(CAPS, with_eigen=jspec.needs_eigen)
    jp = jg.pack_graphs_aligned(jr.apply_transforms(jspec, _graphs(js, seed)), window=W, **caps)
    tp = tg.pack_graphs_aligned(tr.apply_transforms(tspec, _graphs(ts, seed)), window=W, **caps)
    return jp, tp


def _assert_batches_equal(jax_batch: dict, port_batch: dict):
    """Equal keys, shapes and values (bf16 values stored as int32 in the
    port), except the JAX package's bf16 one-hots of the gather layout and
    the port's marker of the compact window count T, which must equal the
    count the JAX package reads off ``spill_blk_window``."""
    jax_batch = {k: v for k, v in jax_batch.items() if k != "spill_gblk_onehot"}
    port_batch = dict(port_batch)
    if "spill_blk_window" in jax_batch:
        t = int(np.asarray(jax_batch["spill_blk_window"]).max()) + 1
        assert port_batch.pop("spill_blk_compact").shape == (t,)
    assert set(jax_batch) == set(port_batch)
    for k, v in jax_batch.items():
        a = np.asarray(v).astype(np.float64)
        b = np.asarray(port_batch[k]).astype(np.float64)
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.fixture(scope="module")
def batches():
    """Per model: (JAX slot batch, port slot batch on the CPU, port plain
    batch on the CPU)."""
    out = {}
    for name in SMALL_PARAMS:
        jp, tp = _packed(name)
        out[name] = (
            jb.as_batch(jp, blocked="local_slots", window=W),
            tb.to_device(tb.as_batch(tp, blocked="local_slots", window=W), "cpu"),
            tb.to_device(tb.as_batch(tp), "cpu"),
        )
    return out


@pytest.mark.parametrize("name", ["gin", "pna", "dgn", "gat"])
def test_spill_layout_equals_jax(name):
    """The slot layout with a spill tail: no prefix layout, the spill lanes
    in blocked order and the blocked layout's keys, equal to the JAX
    package's."""
    jp, tp = _packed(name)
    jbatch = jb.as_batch(jp, blocked="local_slots", window=W)
    tbatch = tb.as_batch(tp, blocked="local_slots", window=W)
    assert tbatch["slot_spill_mask"].sum() > 100  # a real spill tail
    assert "slot_meta" not in tbatch and "slot_pstack" not in tbatch
    assert "spill_gblk_src" in tbatch and "spill_gblk_onehot" in jbatch
    _assert_batches_equal(jbatch, tbatch)
    # Every real lane points at an edge that crosses a window or overflows
    # its row's slots; the blocks of one receiver window are consecutive.
    sp = tbatch["slot_spill"][tbatch["slot_spill_mask"]]
    assert len(set(sp.tolist())) == sp.shape[0]
    assert (np.diff(tbatch["spill_blk_window"]) >= 0).all()


def test_spill_capacity_reconciled_when_every_bucket_spills():
    """A stream whose every bucket spills gets one spill capacity (JAX's
    reconciliation), and the buckets equal the JAX package's."""
    jgs = jr.apply_transforms(jr.get("pna"), _graphs(js, 5) + _graphs(js, 6))
    tgs = tr.apply_transforms(tr.get("pna"), _graphs(ts, 5) + _graphs(ts, 6))
    caps = dict(node_capacity=767, edge_capacity=3072, graph_capacity=16)
    jbuckets = list(jg.pack_dataset(jgs, align_window=W, **caps))
    tbuckets = list(tg.pack_dataset(tgs, align_window=W, **caps))
    jbatches = jb.as_batches_uniform(jbuckets, blocked="local_slots", window=W)
    tbatches = tb.as_batches_uniform(tbuckets, blocked="local_slots", window=W)
    assert len(tbatches) >= 2 and all(b["slot_spill_mask"].any() for b in tbatches)
    for a, b in zip(jbatches, tbatches):
        _assert_batches_equal(a, b)


def _jax_kernel(module: str, name: str, *args, **kw) -> np.ndarray:
    import importlib

    mod = importlib.import_module(f"flowgnn_tpu.ops.pallas.{module}")
    conv = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    return np.asarray(getattr(mod, name)(*map(conv, args), **{k: conv(v) for k, v in kw.items()}))


def _kernel_case(case: str, batches: dict):
    """(port result, JAX result) of one per-layer kernel on seeded operands
    over a spilling slot batch's layout."""
    rng = np.random.default_rng(7)
    f32 = lambda *s, sd=0.5: rng.normal(0, sd, s).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    jbatch = batches["pna"][0]
    n = jbatch["node_feat"].shape[0]
    slots = jbatch["slot_geom"].shape[-1]
    if case == "segment_sum":
        vloc, bw = jbatch["spill_blk_vlocal"], jbatch["spill_blk_window"]
        vals = f32(vloc.shape[0], 40)
        nwin = int(bw.max()) + 1
        got = spmm.windowed_segment_sum(t(vals), t(vloc)[:, None], t(bw), 512, nwin)
        return got, _jax_kernel("spmm", "windowed_segment_sum", vals, vloc[:, None], bw,
                                window=512, num_windows=nwin)
    if case == "pna_stats":
        h = f32(n, 24, sd=2.0)
        args = (jbatch["slot_src"], h, W, slots, 31.9990234375, -32.0)
        return (local_layer.pna_local_stats_ell(t(args[0]), t(h), *args[2:]),
                _jax_kernel("local_layer", "pna_local_stats_ell", *args))
    if case.startswith("dgn"):
        jbatch = batches["dgn"][0]
        n = jbatch["node_feat"].shape[0]
        slots = jbatch["slot_geom"].shape[-1]
        d = 24
        abssum = jbatch["eig_abssum"]
        ops = dict(
            slot_src=jbatch["slot_src"], h=f32(n, d), eig=jbatch["node_eigen"][:, 1].copy(),
            inv_deg=(1 / np.maximum(jbatch["out_deg"], 1)).astype(np.float32),
            eigw_sum=jbatch["eigw_sum"],
            inv_abssum=(1 / np.where(abssum == 0, 1 / 8192, abssum)).astype(np.float32),
            w_post=f32(2 * d, d, sd=0.2), b_post=f32(1, d), window=W, slots=slots,
            m_spill=f32(n, 2 * d) if case == "dgn_spill" else None,
        )
        port = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()}
        return (local_layer.dgn_local_layer_slots(**port),
                _jax_kernel("local_layer", "dgn_local_layer_slots", **ops))
    jbatch = batches["gat"][0]
    n = jbatch["node_feat"].shape[0]
    slots = jbatch["slot_geom"].shape[-1]
    heads, hd = 2, 16
    stack = np.asarray(jbatch["slot_stack"]).astype(np.int32)
    ops = dict(h=f32(n, hd), s_src=f32(n, heads, sd=2.0), s_tgt=f32(n, heads, sd=2.0),
               window=W, slots=slots, num_heads=heads, divide=case == "gat_divide")
    port = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()}
    return (local_layer.gat_local_message_slots(t(stack), **port),
            _jax_kernel("local_layer", "gat_local_message_slots",
                        stack.astype(np.float32), **ops))


@pytest.mark.parametrize("case", [
    "segment_sum", "pna_stats", "dgn", "dgn_spill", "gat_divide", "gat_sums",
])
def test_layer_kernel_matches_jax(case, batches, monkeypatch):
    """Kernel table rows 24, 19, 22 (without and with ``m_spill``) and 21
    (``divide`` True and False): the plain version against the Pallas
    kernel, f32, to 1e-5 of the output's scale (summation order only; the
    scores stay far below f32 exp's overflow)."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    got, expect = _kernel_case(case, batches)
    assert got.dtype == torch.float32 and got.shape == expect.shape
    scale = max(1.0, float(np.abs(expect).max()))
    assert np.abs(expect).max() > 1e-2
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


def test_segment_sum_bound_of_windows_reads_zero():
    """Output windows that no block names come out zero: past the last
    block's window, and between blocks."""
    vloc = torch.tensor([3, 512, 7, 3], dtype=torch.int32)[:, None]
    bw = torch.tensor([0, 1], dtype=torch.int32)
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = spmm.windowed_segment_sum(vals, vloc, bw, 512, 4).reshape(4, 512, 2)
    assert out[0, 3].tolist() == [0.0, 1.0] and out[1, 7].tolist() == [4.0, 5.0]
    assert out[1, 3].tolist() == [6.0, 7.0] and not out[2:].any()
    assert out.sum().item() == vals[[0, 2, 3]].sum().item()


@pytest.mark.parametrize("name", ["pna", "dgn", "gat", "gin", "gin-vn", "gcn"])
def test_spill_forward_matches_jax(name, batches, monkeypatch):
    """The forward on a spilling slot batch against the JAX forward on the
    same batch and weights (Pallas in interpret mode), f32 to 1e-5 of the
    predictions' scale; and against the port's own plain edge-list path.
    PNA, DGN and GAT run their per-layer slot kernels and the spill tail;
    GIN, GIN-VN and GCN the plain loop, as the JAX package's dispatch
    does."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    jbatch, slot, plain = batches[name]
    fwd, jfwd = tr.get(name).forward, jr.get(name).forward
    params = SMALL_PARAMS[name]()
    got = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), slot, tn.FLOAT32)
    expect = np.asarray(jfwd(jb.prepare_params(params, jn.FLOAT32), jbatch, jn.FLOAT32))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.ptp(expect[:G]) > 1e-3 and np.isfinite(expect[:G]).all()
    scale = max(1.0, float(np.abs(expect[:G]).max()))
    np.testing.assert_allclose(got[:G].numpy() / scale, expect[:G] / scale, rtol=1e-5, atol=1e-5)
    own = fwd(tl.params_from_numpy(params, tn.FLOAT32, "cpu"), plain, tn.FLOAT32)
    np.testing.assert_allclose(got[:G].numpy() / scale, own[:G].numpy() / scale,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pna", "dgn", "gat"])
def test_spill_tail_is_live(name, batches):
    """Dead-wiring guard: dropping the spill tail's lanes changes the
    output."""
    _, slot, _ = batches[name]
    params = tl.params_from_numpy(SMALL_PARAMS[name](), tn.FLOAT32, "cpu")
    fwd = tr.get(name).forward
    good = fwd(params, slot, tn.FLOAT32)
    cut = dict(slot, slot_spill_mask=torch.zeros_like(slot["slot_spill_mask"]))
    bad = fwd(params, cut, tn.FLOAT32)
    assert not torch.allclose(bad[:G], good[:G], rtol=1e-4, atol=1e-4)


def test_what_still_raises(batches):
    """PNA's no-spill per-layer batch needs ``pna_local_layer`` (row 20), and
    a spilling ELL bucket rows 13, 15 and 24: both raise."""
    jp, tp = _packed("pna")
    params = tl.params_from_numpy(SMALL_PARAMS["pna"](), tn.FLOAT32, "cpu")
    small = tg.pack_graphs_aligned(tr.apply_transforms(tr.get("pna"), ts.synthetic_molhiv(8, seed=1)),
                                   window=W, **CAPS)
    no_spill = tb.to_device(tb.as_batch(small, blocked="local_slots", window=W), "cpu")
    assert not no_spill["slot_spill"].shape[-1]
    with pytest.raises(NotImplementedError, match="row 20"):
        tr.get("pna").forward(params, no_spill, tn.FLOAT32, return_intermediates=True)
    with pytest.raises(NotImplementedError, match="rows 13 / 15.*row 24"):
        tb.as_batch(tp, blocked="local_ell", window=W, block=384)
