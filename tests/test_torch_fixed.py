"""The ap_fixed emulation mode of the port (``Precision(fixed=...)``) on the
CPU, against the JAX package with ``jax_enable_x64`` on.

(a) ``FixedSpec`` and its two quantizers bit for bit against the JAX
package's, on both overflow modes, both grids and f64 / f32 / bf16 inputs;
(b) ``params_from_numpy`` against ``prepare_params`` for all six models, key
by key, bit for bit; (c) each model's fixed forward against the JAX forward
on plain, edge-block, slot and ELL batches, and GIN-VN's saturating rung:
``test_torch_fixed_forward.py``, over this file's batches; (d) every model's
output and intermediates on the grid, in range and deterministic; (e) the
kernel wrappers each batch kind reaches in the fixed mode (monkeypatched
counters): none but ``segment_sum_blocked``, once per layer on an edge-block
batch; (f) ``InferenceStream`` in the fixed mode, ``run`` and
``run_pipelined`` equal to the forward bucket by bucket; (g) GIN's fixed
forward beside the bit-exact oracle
``flowgnn_tpu/reference/fixed_exact.py:gin_forward_fixed_exact``; and the
float envelope that ``chip_smoke.py`` phase 10 gates."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.core import synthetic as js
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.reference.fixed_exact import gin_forward_fixed_exact
from flowgnn_tpu.reference.oracles import gin_forward as gin_float_oracle
from flowgnn_tpu_torch import FIXED_16_3, FIXED_16_6
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import dgn, gat, gcn, gin, pna
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.runtime import stream as rs

G = 16
MODELS = ("gin", "gin-vn", "gcn", "pna", "dgn", "gat")
KINDS = ("plain", "blocked", "slots", "ell")
CAPS = dict(node_capacity=1023, edge_capacity=2560, graph_capacity=16)
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SPECS = [jn.FixedSpec(16, 6), jn.FixedSpec(16, 3), jn.FixedSpec(16, 6, "wrap"),
         jn.FixedSpec(16, 3, "wrap")]
SPEC_IDS = ["16_6-sat", "16_3-sat", "16_6-wrap", "16_3-wrap"]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for each test: beside other pytest-xdist workers,
    torch's default of a thread per core makes the fixed forward's many
    small ops wait on each other (a 20 ms forward took 10 s with five busy
    processes beside it, 0.3 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_spec(spec: jn.FixedSpec) -> tn.FixedSpec:
    return tn.FixedSpec(spec.width, spec.int_bits, spec.overflow)


def _bits(x: np.ndarray) -> np.ndarray:
    """The f32 bit patterns (so that −0.0 and 0.0 differ)."""
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _inputs(spec: jn.FixedSpec) -> np.ndarray:
    """Grid points, ± half an ulp and ± a thousandth of one around them,
    the two extremes and one ulp past them, values far out of range on both
    sides, ±0.0 and −0.0, and seeded normals across the range."""
    eps = spec.epsilon
    grid = np.arange(-40, 41, dtype=np.float64) * eps * 37
    edges = np.array([spec.max_val, spec.min_val, spec.max_val + eps, spec.min_val - eps,
                      spec.max_val + 0.5 * eps, spec.min_val - 0.5 * eps,
                      3 * spec.max_val, 3 * spec.min_val, 1e6, -1e6, 0.0, -0.0])
    rng = np.random.default_rng(0)
    return np.concatenate([grid, grid + 0.5 * eps, grid - 0.5 * eps, grid + 1e-3 * eps,
                           grid - 1e-3 * eps, edges, rng.normal(0, spec.max_val, 500)])


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_fixed_spec_properties_equal_jax(spec):
    """The grid's properties equal the JAX package's; the module constants
    are its ``AP_FIXED_16_6`` / ``AP_FIXED_16_3``, and the registry gives
    each model its grid (DGN ap_fixed<16,3>, the rest <16,6>)."""
    t = _port_spec(spec)
    for prop in ("frac_bits", "scale", "max_val", "min_val", "epsilon"):
        assert getattr(t, prop) == getattr(spec, prop), prop
    assert tn.AP_FIXED_16_6 == tn.FixedSpec(16, 6) and tn.AP_FIXED_16_3 == tn.FixedSpec(16, 3)
    assert (FIXED_16_6.fixed, FIXED_16_3.fixed) == (tn.AP_FIXED_16_6, tn.AP_FIXED_16_3)
    for name in MODELS:
        assert _port_spec(jr.get(name).fixed_spec) == tr.get(name).fixed_spec, name


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_quantize_matches_jax_bit_for_bit(spec, dtype):
    """``quantize`` (f32 cast, floor in f32, clip or floor-mod wrap) gives
    the JAX package's bits on f64, f32 and bf16 inputs and returns f32;
    ``quantize_np`` (floor in f64, no f32 cast) gives its numpy twin's bits.
    Wrap is floor-mod: a value below ``min_val`` wraps to the top of the
    range, where ``torch.fmod`` would not."""
    x = _inputs(spec)
    t = _port_spec(spec)
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    if dtype == "bf16":  # the same bf16 inputs in both libraries
        assert np.array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    got = t.quantize(xt)
    want = np.asarray(spec.quantize(xj))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    scaled = got.double().numpy() * t.scale
    assert np.array_equal(scaled, np.round(scaled))
    assert t.min_val <= got.min().item() and got.max().item() <= t.max_val
    if spec.overflow == "wrap" and dtype != "bf16":
        assert t.quantize(torch.tensor([t.min_val - t.epsilon], dtype=tdt)).item() == t.max_val
    xn = x if dtype == "f64" else np.asarray(xt.float().numpy())
    np.testing.assert_array_equal(_bits(t.quantize_np(xn)), _bits(spec.quantize_np(xn)))


def test_quantize_np_floors_in_f64():
    """The two quantizers stay different, as the JAX package has them: just
    below a grid point, ``quantize_np`` floors the f64 value down one ulp,
    ``quantize`` first rounds it to f32, onto the grid point."""
    x = np.array([5 / 1024 - 1e-12, -3 / 1024 - 1e-12])
    on_grid = np.array([5 / 1024, -3 / 1024], np.float32)
    below = on_grid - np.float32(1 / 1024)
    t, j = tn.AP_FIXED_16_6, jn.AP_FIXED_16_6
    for got in (t.quantize_np(x), j.quantize_np(x)):
        assert np.array_equal(got, below)
    for got in (t.quantize(torch.from_numpy(x)).numpy(), np.asarray(j.quantize(jnp.asarray(x)))):
        assert np.array_equal(got, on_grid)


def test_precision_q_is_free_in_float_modes():
    """In the float modes ``q`` is the tensor itself (no copy, no op) and
    ``q_np`` an f32 array; in the fixed mode ``q`` returns f32 whatever the
    compute dtype, and ``Precision(fixed=...)`` builds for both grids."""
    x = torch.randn(5, 3, dtype=torch.float64)
    for prec in (tn.FLOAT32, tn.FLOAT64, tn.BF16):
        y = x.to(prec.compute_dtype)
        assert prec.q(y) is y
        assert prec.q_np(np.ones(3)).dtype == np.float32
    for cdt in (torch.float32, torch.float64, torch.bfloat16):
        prec = tn.Precision(compute_dtype=cdt, fixed=tn.AP_FIXED_16_3)
        assert prec.q(x.to(cdt)).dtype == torch.float32
    with pytest.raises(ValueError):
        tn.Precision(compute_dtype=torch.float16, fixed=tn.AP_FIXED_16_6)


def _params(name: str) -> dict:
    """The model's seeded synthetic weights at the registry's full widths."""
    return getattr(loaders, f"synthetic_{name.split('-')[0]}_params")(0)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_params_from_numpy_matches_prepare_params(name, dtype):
    """In the fixed mode every floating weight, PNA's 0-d ``avg_deg``
    included, is snapped by ``q_np`` before the cast, key by key the JAX
    package's ``prepare_params`` bit for bit; an integer array passes
    through as it is."""
    tdt, jdt = DTYPES[dtype]
    spec = jr.get(name).fixed_spec
    params = dict(_params(name), counts=np.arange(4, dtype=np.int32))
    got = loaders.params_from_numpy(params, tn.Precision(tdt, _port_spec(spec)), "cpu")
    want = jb.prepare_params(params, jn.Precision(jdt, spec))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        w = np.asarray(w)
        if k == "counts":
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
            continue
        assert g.dtype == tdt, k
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)
        if dtype != "bf16":  # bf16 rounds the snapped values off the grid
            assert _on_grid(g.double().numpy(), spec), k
    if name == "pna":
        assert got["avg_deg"].dim() == 0


@functools.cache
def _graphs(name: str):
    """(JAX, port) 16 molhiv-shaped graphs after the model's transforms."""
    return (jr.apply_transforms(jr.get(name), js.synthetic_molhiv(G, seed=7)),
            tr.apply_transforms(tr.get(name), ts.synthetic_molhiv(G, seed=7)))


@functools.cache
def _batches(name: str, kind: str):
    """(JAX numpy batch, port CPU batch) of one batch kind: the plain edge
    list and the edge-block layout of an unaligned packing, the slot and ELL
    layouts of a window-aligned one at the port's geometry."""
    jgs, tgs = _graphs(name)
    eig = tr.get(name).needs_eigen
    if kind in ("plain", "blocked"):
        jp = jg.pack_graphs(jgs, with_eigen=eig, **CAPS)
        tp = tg.pack_graphs(tgs, with_eigen=eig, **CAPS)
        kw = dict(blocked=kind == "blocked")
    else:
        w, block = tb.choose_geometry(name, max(g.num_nodes for g in tgs))
        jp = jg.pack_graphs_aligned(jgs, window=w, with_eigen=eig, **CAPS)
        tp = tg.pack_graphs_aligned(tgs, window=w, with_eigen=eig, **CAPS)
        kw = (dict(blocked="local_slots", window=w) if kind == "slots"
              else dict(blocked="local_ell", window=w, block=block))
    jbatch, batch = jb.as_batch(jp, **kw), tb.as_batch(tp, **kw)
    assert ("slot_meta" in batch) == (kind == "slots") and ("loc_ell" in batch) == (kind == "ell")
    assert ("blk_vlocal" in batch) == (kind == "blocked")
    return jbatch, tb.to_device(batch, "cpu")


def _on_grid(x: np.ndarray, spec) -> bool:
    s = np.asarray(x, np.float64) * spec.scale
    return bool(np.isfinite(s).all() and np.array_equal(s, np.round(s))
                and spec.min_val <= np.min(x) and np.max(x) <= spec.max_val)


@pytest.mark.parametrize("name", MODELS)
def test_fixed_outputs_on_grid_in_range_deterministic(name):
    """Every model's predictions, layers and pooled h on every batch kind
    lie on its grid and in its range, and a second run gives the same bits."""
    spec = tr.get(name).fixed_spec
    prec = tn.Precision(fixed=spec)
    p = loaders.params_from_numpy(_params(name), prec, "cpu")
    for kind in KINDS:
        batch = _batches(name, kind)[1]
        runs = [tr.get(name).forward(p, batch, prec, return_intermediates=True) for _ in range(2)]
        for out, inter in runs:
            for x in [out[:G]] + inter["layers"] + [inter["h_graph"][:G]]:
                assert x.dtype == torch.float32 and _on_grid(x.numpy(), spec), kind
        a, b = runs
        assert torch.equal(a[0], b[0]), kind
        assert all(torch.equal(x, y) for x, y in zip(a[1]["layers"], b[1]["layers"])), kind


OP_MODULES = ("flowgnn_tpu_torch.ops.local_layer", "flowgnn_tpu_torch.ops.fused_layer",
              "flowgnn_tpu_torch.ops.spmm")


def _count_wrappers(monkeypatch) -> dict:
    """Replace every function of the kernel modules that the models (and
    ``models.base``) hold by a counting pass-through; returns the counts."""
    counts: dict = {}
    for mod in (tb, gin, gcn, pna, dgn, gat):
        for attr in dir(mod):
            fn = getattr(mod, attr)
            if callable(fn) and getattr(fn, "__module__", "") in OP_MODULES:
                def counted(*a, _fn=fn, _name=attr, **kw):
                    counts[_name] = counts.get(_name, 0) + 1
                    return _fn(*a, **kw)

                monkeypatch.setattr(mod, attr, counted)
    return counts


@pytest.mark.parametrize("name", MODELS)
def test_fixed_mode_reaches_no_kernel_but_row24(name, monkeypatch):
    """In the fixed mode no batch kind reaches a kernel wrapper (every path
    is gated off by ``prec.fixed is None``, as in the JAX package) except an
    edge-block batch, whose message sums call ``segment_sum_blocked`` (row
    24) once per layer; in f32 the same slot batch reaches its kernel, so
    the counters are live."""
    counts = _count_wrappers(monkeypatch)
    spec = tr.get(name).fixed_spec
    layers = tr.get(name).num_layers
    for mode in (tn.Precision(fixed=spec), tn.Precision(torch.float64, spec)):
        p = loaders.params_from_numpy(_params(name), mode, "cpu")
        for kind in KINDS:
            counts.clear()
            tr.get(name).forward(p, _batches(name, kind)[1], mode)
            expect = {"segment_sum_blocked": layers} if kind == "blocked" else {}
            assert counts == expect, (kind, counts)
    counts.clear()
    p32 = loaders.params_from_numpy(_params(name), tn.FLOAT32, "cpu")
    tr.get(name).forward(p32, _batches(name, "slots")[1], tn.FLOAT32)
    assert counts, "the float slot path reached no wrapper"


@pytest.mark.parametrize("name,prec", [("gin", FIXED_16_6), ("dgn", FIXED_16_3)],
                         ids=["gin", "dgn"])
def test_fixed_stream_equals_forward(name, prec):
    """``InferenceStream`` in the fixed mode on the CPU: two weight sets
    flipped halfway, buckets of at most 4 graphs; ``run`` and
    ``run_pipelined`` give each bucket's eager fixed forward bit for bit,
    on the grid; GIN's predictions equal the JAX ``InferenceStream``'s in
    the same mode."""
    from flowgnn_tpu.runtime.stream import InferenceStream as JaxStream

    graphs = ts.synthetic_molhiv(12, seed=3)
    jgraphs = js.synthetic_molhiv(12, seed=3)
    sets = [getattr(loaders, f"synthetic_{name}_params")(s, dim=16, layers=2,
                                                         **({"hidden": 32} if name == "gin"
                                                            else {}))
            for s in (0, 1)]
    caps = dict(node_capacity=255, edge_capacity=1024, graph_capacity=4)
    items = [(g, int(i >= 6)) for i, g in enumerate(graphs)]
    stream = rs.InferenceStream(name, sets, prec, device="cpu", **caps)
    seq = np.array(list(stream.run(items)))
    pipe = np.array(list(stream.run_pipelined(items, depth=2, chain=2, workers=2)))
    assert seq.shape == (12,) and np.array_equal(seq, pipe)
    assert _on_grid(seq, prec.fixed) and np.ptp(seq) > 0
    off = 0
    for bucket, sid in stream._bucketize(items):
        batch, n = stream._make_batch(bucket)
        p = loaders.params_from_numpy(sets[sid], prec, "cpu")
        want = tr.get(name).forward(p, tb.to_device(batch, "cpu"), prec)[:n, 0].numpy()
        assert np.array_equal(seq[off:off + n], want)
        off += n
    assert off == 12
    if name == "gin":
        jitems = [(g, s) for g, (_, s) in zip(jgraphs, items)]
        jprec = jn.Precision(fixed=jr.get(name).fixed_spec)
        want = np.array(list(JaxStream(name, sets, jprec, **caps).run(jitems)))
        np.testing.assert_array_equal(seq, want)


# |GIN fixed − the bit-exact oracle| on the 16 graphs with the seeded weights
# (measured: max 4.236, median 1.187). The oracle replays the device's
# truncation of every MLP-1 product, its running MLP-2 sums and their wrap;
# the emulation quantizes stage boundaries only and saturates, so the two
# part by more than the grid: the oracle sits 4.79 from the float oracle at
# most, the emulation 2.49.
EXACT_MAX, EXACT_MEDIAN = 4.5, 1.25


def test_gin_fixed_beside_bit_exact_oracle():
    """GIN's fixed forward beside ``gin_forward_fixed_exact`` on the seeded
    weights (its range checks take them), as ``tests/test_golden.py`` holds
    the oracle to the float path: within ``EXACT_MAX`` everywhere and
    ``EXACT_MEDIAN`` at the median, and closer to the float oracle than the
    bit-exact oracle is."""
    params = _params("gin")
    jgs, _ = _graphs("gin")
    exact = np.array([gin_forward_fixed_exact(params, g)["out"][0] for g in jgs], np.float64)
    floatv = np.array([gin_float_oracle(params, g)["out"].ravel()[0] for g in jgs])
    prec = FIXED_16_6
    ours = tr.get("gin").forward(loaders.params_from_numpy(params, prec, "cpu"),
                                 _batches("gin", "plain")[1], prec)[:G, 0].double().numpy()
    diff = np.abs(ours - exact)
    assert diff.max() < EXACT_MAX and np.median(diff) < EXACT_MEDIAN, diff
    assert np.abs(ours - floatv).max() < np.abs(exact - floatv).max()


# The JAX test's envelope, max |fixed − float| / max(1, |float|)
# (tests/test_fixed_point.py:50-53), which ``chip_smoke.py`` phase 10 gates
# for these models on the 4113-graph molhiv stream. Measured here on its
# first 512 graphs: GCN 0.0123, PNA 0.1227, DGN 0.0114, GAT 0.1241 (on all
# 4113: 0.0128, 0.1227, 0.0326, 0.1311). GIN's and GIN-VN's seeded weights
# leave it (6.9 and 5.5 on 1024 graphs: their float predictions reach 9 and
# 3319, GIN-VN's virtual-node sums saturate), so the card prints theirs only.
ENVELOPE = {"gcn": 0.15, "pna": 0.15, "dgn": 0.6, "gat": 0.15}


@pytest.mark.parametrize("name", sorted(ENVELOPE))
def test_fixed_envelope_on_seeded_weights(name):
    """The fixed mode within the JAX test's envelope of the f32 float path
    on the seeded weights, over the first 512 graphs of the molhiv stream
    ``chip_smoke.py`` runs (``synthetic_dataset("molhiv", seed=0)``)."""
    from flowgnn_tpu_torch.core.synthetic import synthetic_dataset

    spec = tr.get(name)
    graphs = tr.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=512))
    packed = tg.pack_graphs(graphs, node_capacity=16383, edge_capacity=65536, graph_capacity=512,
                            with_eigen=spec.needs_eigen)
    assert packed.num_graphs == 512
    batch = tb.to_device(tb.as_batch(packed), "cpu")
    out = {}
    for prec in (tn.Precision(fixed=spec.fixed_spec), tn.FLOAT32):
        p = loaders.params_from_numpy(_params(name), prec, "cpu")
        out[prec.fixed is None] = spec.forward(p, batch, prec)[:512, 0].double().numpy()
    fixed, floatv = out[False], out[True]
    rel = np.abs(fixed - floatv) / np.maximum(1.0, np.abs(floatv))
    assert rel.max() < ENVELOPE[name] and np.ptp(floatv) > 1e-2, rel.max()
