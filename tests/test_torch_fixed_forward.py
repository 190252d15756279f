"""Each model's ap_fixed forward (``Precision(fixed=...)``) against the JAX
package's on the CPU, with ``jax_enable_x64`` on: 16 molhiv-shaped graphs at
the registry's full widths, on plain, edge-block, slot and ELL batches (the
JAX edge-block path through its Pallas kernel in interpret mode), the
predictions, every layer's h and the pooled h. f64 compute: GIN, GIN-VN,
GCN, PNA and DGN bit-equal, GAT within one grid ulp; f32 and bf16 compute
within the grid ulps stated below; GIN-VN's saturating rung on its own. The
batches, weights and grid helpers are ``test_torch_fixed.py``'s."""

import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders
from test_torch_fixed import (  # noqa: F401 (one_thread: the autouse fixture)
    DTYPES, G, KINDS, MODELS, _batches, _on_grid, _params, _port_spec, one_thread,
)


@functools.cache
def _forwards(name: str, kind: str, dtype: str):
    """(port, JAX) fixed-mode forward with intermediates on one batch kind,
    each a list [predictions of the real graphs, every layer's h, the pooled
    h] as f64 numpy, each computed once."""
    tdt, jdt = DTYPES[dtype]
    spec = jr.get(name).fixed_spec
    tprec, jprec = tn.Precision(tdt, _port_spec(spec)), jn.Precision(jdt, spec)
    params = _params(name)
    jbatch, batch = _batches(name, kind)
    out, inter = tr.get(name).forward(loaders.params_from_numpy(params, tprec, "cpu"), batch,
                                      tprec, return_intermediates=True)
    with mock.patch.dict(os.environ, {"FLOWGNN_PALLAS_INTERPRET": "1"}):
        jout, jinter = jr.get(name).forward(jb.prepare_params(params, jprec), jbatch, jprec,
                                            return_intermediates=True)
    as_list = lambda o, i: [o[:G]] + list(i["layers"]) + [i["h_graph"][:G]]
    assert all(x.dtype == torch.float32 for x in [out] + inter["layers"] + [inter["h_graph"]])
    got = [x.double().numpy() for x in as_list(out, inter)]
    want = [np.asarray(x, np.float64) for x in as_list(jout, jinter)]
    return got, want


def _ulps(got: list, want: list, spec) -> tuple[float, int]:
    """(the largest difference in grid ulps, the entries that differ) over
    the predictions, every layer's h and the pooled h."""
    assert len(got) == len(want)
    d = [np.abs(g - w) * spec.scale for g, w in zip(got, want)]
    return max(x.max() for x in d), sum(int((x > 0).sum()) for x in d)


# Largest difference from the JAX forward in grid ulps, over the predictions,
# every layer's h and the pooled h (16 graphs). f64: five models bit-equal;
# GAT's f32 exp (scores and ELU) differs in the last bit between XLA and
# torch, which moves a floor by one ulp in at most 261 entries (measured 16,
# 61, 181 in layers 2-4 and 3 pooled, on every batch kind). f32: the linears'
# f32 products sum in a different order in the two libraries and a floor
# moves, then later layers carry it (GIN-VN, whose virtual-node sums
# saturate: 8; DGN, whose |m2 − eigw_sum·h| / eig_abssum scales by up to
# 8192: 12); the predictions stay within one ulp. bf16: the same order
# effect at bf16's steps (128 ulps = one bf16 step at ±32), predictions
# within two.
F64_ULPS = {"gat": (1, 261)}
F32_ULPS = {"gin": 1, "gin-vn": 8, "gcn": 0, "pna": 0, "dgn": 12, "gat": 1}
BF16_ULPS = {"gin": 0, "gin-vn": 128, "gcn": 8, "pna": 28, "dgn": 16, "gat": 32}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", MODELS)
def test_fixed_forward_f64_matches_jax(name, kind):
    """Under ``Precision(compute_dtype=float64, fixed=spec)`` every stage is
    a sum, product, division or square root of grid values, exact or
    correctly rounded in both libraries: GIN, GIN-VN, GCN, PNA and DGN give
    the JAX package's bits on every batch kind, every intermediate too; GAT
    within ``F64_ULPS`` (its ``exp``)."""
    got, want = _forwards(name, kind, "f64")
    ulps, n = _ulps(got, want, jr.get(name).fixed_spec)
    bound, count = F64_ULPS.get(name, (0, 0))
    assert ulps <= bound and n <= count, (ulps, n)
    assert np.array_equal(got[0], want[0])  # the predictions bit-equal


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", MODELS)
def test_fixed_forward_f32_matches_jax(name, kind):
    """f32 compute: within ``F32_ULPS`` grid ulps of the JAX forward on every
    batch kind, every intermediate too; the predictions within one ulp."""
    spec = jr.get(name).fixed_spec
    got, want = _forwards(name, kind, "f32")
    assert _ulps(got, want, spec)[0] <= F32_ULPS[name]
    assert np.abs(got[0] - want[0]).max() * spec.scale <= 1


@pytest.mark.parametrize("kind", ["plain", "blocked"])
@pytest.mark.parametrize("name", MODELS)
def test_fixed_forward_bf16_matches_jax(name, kind):
    """bf16 compute, where ``q`` hands f32 activations to bf16 weights (the
    products cast as ``jnp.dot`` promotes them): within ``BF16_ULPS`` grid
    ulps of the JAX forward, every intermediate too; the predictions within
    two."""
    spec = jr.get(name).fixed_spec
    got, want = _forwards(name, kind, "bf16")
    assert _ulps(got, want, spec)[0] <= BF16_ULPS[name]
    assert np.abs(got[0] - want[0]).max() * spec.scale <= 2


def test_gin_vn_fixed_mode_saturates_on_grid():
    """GIN-VN's rung (``tests/test_fixed_point.py``'s
    ``test_gin_vn_fixed_mode_saturates_on_grid``): the virtual node sums
    every node's message, which passes ap_fixed<16,6>'s ±32 on these
    graphs, so the saturating mode clips; its output stays finite, on the
    grid, in range, deterministic and bit-equal to the JAX package's in
    f64."""
    spec = tr.get("gin-vn").fixed_spec
    got, want = _forwards("gin-vn", "plain", "f64")
    prec = tn.Precision(torch.float64, spec)
    out, inter = tr.get("gin-vn").forward(
        loaders.params_from_numpy(_params("gin-vn"), prec, "cpu"), _batches("gin-vn", "plain")[1],
        prec, return_intermediates=True)
    again = [out[:G]] + list(inter["layers"]) + [inter["h_graph"][:G]]
    for g, w, a in zip(got, want, again):
        assert np.array_equal(g, w) and np.array_equal(g, a.double().numpy())
        assert _on_grid(g, spec)
    hit = {v for h in got[1:-1] for v in (h.min(), h.max())}
    assert spec.min_val in hit or spec.max_val in hit  # saturated
