"""The port's sharded steps against the JAX package's on its fake 8-device
CPU mesh, f32 to rtol = atol = 2e-5 (the JAX package's own tolerance for
its sharded tests): ``halo_forward`` over data × edge = (2, 4) and (1, 8)
and ``sharded_forward`` (the replicated-node psum path) over (4, 1),
(2, 4) and (1, 8), for all six models on the plain halo layout and the
plain edge list. Weights are the port's seeded synthetic ones, carried into
JAX through numpy; the port's ranks are threads (``run_threads``). The
local-layout halo cases are in ``test_torch_parallel_local.py``."""

import dataclasses

import numpy as np
import pytest

from flowgnn_tpu.core import graphs as jg
from flowgnn_tpu.core import numerics as jn
from flowgnn_tpu.models import base as jb
from flowgnn_tpu.models import registry as jr
from flowgnn_tpu.parallel import halo as jhalo
from flowgnn_tpu.parallel import inference as jinf
from flowgnn_tpu.parallel.mesh import make_mesh as jax_mesh
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.core import synthetic as ts
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.parallel import halo, inference
from flowgnn_tpu_torch.parallel import mesh as pm
from test_torch_parallel import SMALL

CAPS = dict(node_capacity=1023, edge_capacity=4096, graph_capacity=32)
MODELS = ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"]


def buckets(name: str, count: int, aligned: bool = False, per: int = 30):
    """``count`` buckets of ``per`` transformed molhiv-shaped graphs each, as
    the port packs them and as the same packings in the JAX package."""
    spec = tr.get(name)
    gs = tr.apply_transforms(spec, ts.synthetic_molhiv(per * count, seed=11))
    caps = dict(CAPS, with_eigen=spec.needs_eigen)
    pack = ((lambda g: tg.pack_graphs_aligned(g, window=512, **caps)) if aligned
            else (lambda g: tg.pack_graphs(g, **caps)))
    out = [pack(gs[i * per : (i + 1) * per]) for i in range(count)]
    return out, [jg.PackedGraphs(**dataclasses.asdict(b)) for b in out]


def _port_rank(rank, store, name, data, edge, strategy, stacked, params_np):
    mesh = pm.make_mesh(data, edge, rank=rank, store=store, log=False)
    params = loaders.params_from_numpy(params_np, tn.FLOAT32, "cpu")
    build = inference.halo_forward if strategy == "halo" else inference.sharded_forward
    return build(tr.get(name).forward, mesh, tn.FLOAT32)(params, stacked).numpy()


def run_both(name: str, data: int, edge: int, strategy: str, blocked=None, aligned=False):
    """(the JAX step's [data, G+1, T], every port rank's, the buckets)."""
    bs, jbs = buckets(name, data, aligned)
    params_np = SMALL[name.split("-")[0]]()
    if strategy == "halo":
        kw = dict(k=edge, edge_slack=8.0, blocked=blocked)
        jstacked = jinf.stack_halo_buckets([jhalo.build_halo_batch(b, **kw) for b in jbs])
        stacked = inference.stack_halo_buckets([halo.build_halo_batch(b, **kw) for b in bs])
        jstep = jinf.halo_forward
    else:
        jstacked, stacked = jinf.stack_buckets(jbs), inference.stack_buckets(bs)
        jstep = jinf.sharded_forward
    spec = jr.get(name)
    want = np.asarray(jstep(spec.forward, jax_mesh(data=data, edge=edge), jn.FLOAT32)(
        jb.prepare_params(params_np, jn.FLOAT32), jstacked))
    got = pm.run_threads(_port_rank, data * edge, name, data, edge, strategy, stacked, params_np)
    return want, got, bs


def check(name, want, got, bs):
    assert want.shape == got[0].shape == (len(bs), CAPS["graph_capacity"] + 1, 1)
    for out in got:  # every rank holds every data row
        for i, b in enumerate(bs):
            g = b.num_graphs
            assert np.isfinite(want[i, :g]).all() and np.ptp(want[i, :g]) > 1e-4
            np.testing.assert_allclose(out[i, :g], want[i, :g], rtol=2e-5, atol=2e-5,
                                       err_msg=f"{name} bucket {i}")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("data,edge", [(2, 4), (1, 8)])
def test_halo_forward_matches_jax(name, data, edge):
    want, got, bs = run_both(name, data, edge, "halo")
    check(name, want, got, bs)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("data,edge", [(4, 1), (2, 4), (1, 8)])
def test_sharded_forward_matches_jax(name, data, edge):
    want, got, bs = run_both(name, data, edge, "psum")
    check(name, want, got, bs)
