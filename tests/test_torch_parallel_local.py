"""The halo step on the graph-local layouts, whose kernels run per shard:
against the JAX package's on its fake 8-device CPU mesh (its Pallas kernels
in interpret mode, f32 to 2e-5) for each model path that launches a kernel
on a halo shard — GIN / GIN-VN ELL with straddling graphs (row 31 and the
halo spill tail) and window-aligned (row 8), GCN ELL (rows 14 and 9), PNA
slots aligned (row 3) and straddling (row 19), DGN slots (row 4) and ELL
(row 16), GAT slots (row 5) and ELL (row 17) — and against the port's own
single-device forward of the same packing, for all six models on all three
halo layouts at k = 2 and 4, in f64 to 1e-9 (DGN 1e-6, whose |m2 − ews·h|
cancels); GAT with ``fuse_layers`` (row 23) on a halo ELL shard."""

import numpy as np
import pytest

from flowgnn_tpu_torch.core import numerics as tn
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.models import registry as tr
from flowgnn_tpu_torch.params import loaders
from flowgnn_tpu_torch.parallel import halo, inference
from flowgnn_tpu_torch.parallel import mesh as pm
from test_torch_parallel import SMALL
from test_torch_parallel_forward import buckets, check, run_both


@pytest.mark.parametrize("name,blocked,aligned", [
    ("gin", "local_ell", False), ("gin", "local_ell", True), ("gin-vn", "local_ell", False),
    ("gcn", "local_ell", False), ("gcn", "local_ell", True), ("pna", "local_slots", True),
    ("pna", "local_slots", False), ("dgn", "local_slots", True), ("dgn", "local_ell", False),
    ("gat", "local_slots", True), ("gat", "local_ell", False),
])
def test_halo_local_layouts_match_jax(name, blocked, aligned, monkeypatch):
    monkeypatch.setenv("FLOWGNN_NO_NATIVE", "1")
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    want, got, bs = run_both(name, 1, 2, "halo", blocked=blocked, aligned=aligned)
    check(name, want, got, bs)


def _f64_rank(rank, store, name, k, stacked, params_np):
    mesh = pm.make_mesh(1, k, rank=rank, store=store, log=False)
    params = loaders.params_from_numpy(params_np, tn.FLOAT64, "cpu")
    step = inference.halo_forward(tr.get(name).forward, mesh, tn.FLOAT64)
    return step(params, stacked)[0].numpy()


@pytest.mark.parametrize("name", ["gin", "gin-vn", "gcn", "gat", "pna", "dgn"])
@pytest.mark.parametrize("blocked,aligned", [
    (None, False), ("local_ell", True), ("local_ell", False), ("local_slots", True),
    ("local_slots", False),
])
def test_halo_forward_equals_single_device_f64(name, blocked, aligned):
    (packed,), _ = buckets(name, 1, aligned)
    params_np = SMALL[name.split("-")[0]]()
    p64 = loaders.params_from_numpy(params_np, tn.FLOAT64, "cpu")
    want = tr.get(name).forward(p64, tb.to_device(tb.as_batch(packed), "cpu"),
                                tn.FLOAT64).numpy()
    g = packed.num_graphs
    tol = 1e-6 if name == "dgn" else 1e-9
    for k in (2, 4):
        stacked = inference.stack_halo_buckets([halo.build_halo_batch(
            packed, k=k, edge_slack=2.0 * k, blocked=blocked)])
        for out in pm.run_threads(_f64_rank, k, name, k, stacked, params_np):
            assert out.dtype == np.float64 and np.isfinite(out[:g]).all()
            np.testing.assert_allclose(out[:g], want[:g], rtol=tol, atol=tol,
                                       err_msg=f"{name} {blocked} k={k}")


def _fused_rank(rank, store, stacked, params_np, prec):
    from flowgnn_tpu_torch.models import base as tbase
    from flowgnn_tpu_torch.models import gat

    mesh = pm.make_mesh(1, 2, rank=rank, store=store, log=False)
    params = loaders.params_from_numpy(params_np, prec, "cpu")
    batch = tbase.to_device(inference.halo_shard_slice(stacked, mesh), "cpu")
    return gat.forward(params, batch, prec, fuse_layers=True, edge_axis=mesh.edge)[:, 0].numpy()


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "straddling"])
def test_halo_gat_fused_layers(aligned, monkeypatch):
    """GAT's ``fuse_layers`` on a halo ELL shard: row 23 for every layer but
    the last (its spill sums from the layer's exchanged [h ‖ s_tgt] rows),
    row 17 for the last, per rank; f64 equal to the single-device forward."""
    import threading

    from flowgnn_tpu_torch.models import gat

    (packed,), _ = buckets("gat", 1, aligned)
    params_np = SMALL["gat"]()
    calls, lock = {}, threading.Lock()
    for fn_name in ("gat_local_layer_ell", "gat_local_message_ell"):
        fn = getattr(gat, fn_name)

        def wrapper(*args, _fn=fn, _name=fn_name, **kw):
            with lock:
                calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(gat, fn_name, wrapper)
    stacked = inference.stack_halo_buckets([halo.build_halo_batch(
        packed, k=2, edge_slack=4.0, blocked="local_ell")])
    assert (stacked["senders"].shape[-1] > stacked["loc_ulocal"].shape[-1]) == (not aligned)
    p64 = loaders.params_from_numpy(params_np, tn.FLOAT64, "cpu")
    want = tr.get("gat").forward(p64, tb.to_device(tb.as_batch(packed), "cpu"),
                                 tn.FLOAT64)[:, 0].numpy()
    g = packed.num_graphs
    for out in pm.run_threads(_fused_rank, 2, stacked, params_np, tn.FLOAT64):
        np.testing.assert_allclose(out[:g], want[:g], rtol=1e-9, atol=1e-9)
    layers = params_np["proj_w"].shape[0]
    assert calls == {"gat_local_layer_ell": 2 * (layers - 1), "gat_local_message_ell": 2}
