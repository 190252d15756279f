"""The port's slot megakernels (on the CPU: their plain versions) against
the JAX Pallas kernels in interpret mode, on identical operands. The port's
GAT kernel takes the natural per-layer weights; the JAX package's default
GAT kernel, ``gat_local_model_pairs``, their block-diagonal two-window forms,
which ``_gat_pairs_operands`` builds from them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
from flowgnn_tpu_torch.core.numerics import BF16, FLOAT32
from flowgnn_tpu_torch.core.synthetic import random_molecule_graph, synthetic_molhiv
from flowgnn_tpu_torch.models import base, dgn, gat, gcn, gin, pna, registry
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params import loaders
from test_torch_cuda import (
    _dgn_operands, _ell_batch, _gat_message_overflow_operands, _gat_operands,
    _gat_overflow_operands, _gcn_operands, _operands, _pna_operands, _port, _slot_batch,
    _spill_batch,
)


def _jax_kernel(name: str, ops: dict) -> np.ndarray:
    from flowgnn_tpu.ops.pallas import local_layer as jax_local_layer

    return np.asarray(getattr(jax_local_layer, name)(**{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()
    }))


def _gat_pairs_operands(ops: dict) -> dict:
    """The port's GAT operands in ``gat_local_model_pairs``'s forms: per
    layer [[proj, 0, skip, 0], [0, proj, 0, skip]], [[a_tgt, 0, a_src, 0],
    [0, a_tgt, 0, a_src]] and [[pred_hd, 0], [0, pred_hd]]; the source
    stack as floats."""
    hd, nh, L = ops["h0"].shape[1], ops["num_heads"], ops["num_layers"]
    z, zh, zt = np.zeros((hd, hd)), np.zeros((hd, nh)), np.zeros_like(ops["pred_hd"])
    blk = lambda l, w: w[l * hd : (l + 1) * hd]
    glue2 = [np.block([[p, z, s, z], [z, p, z, s]]) for p, s in (
        (blk(l, ops["proj_w"]), blk(l, ops["skip_w"])) for l in range(L - 1))]
    ab = [np.block([[a[:, nh:], zh, a[:, :nh], zh], [zh, a[:, nh:], zh, a[:, :nh]]])
          for a in (blk(l, ops["a_all"]) for l in range(L))]
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        slot_stack=f32(ops["slot_pstack"]), h0=ops["h0"], skip0=ops["skip0"],
        glue2_w=f32(np.concatenate(glue2)), ab_w=f32(np.concatenate(ab)),
        pool_gl=ops["pool_gl"], pred2_w=f32(np.block([[ops["pred_hd"], zt], [zt, ops["pred_hd"]]])),
        **{k: ops[k] for k in ("window", "slots", "num_heads", "num_layers", "gmax",
                               "prefix_caps")},
    )


# Port kernel → (the JAX kernel it is held against, operand conversion).
_JAX_FORMS = {"gat_local_model_slots": ("gat_local_model_pairs", _gat_pairs_operands)}


@pytest.mark.parametrize("name,ops", [
    ("gin_local_model_slots", lambda: _operands(False)),
    ("gin_local_model_slots", lambda: _operands(True)),
    ("gcn_local_model_slots", _gcn_operands),
    ("pna_local_model", _pna_operands),
    ("dgn_local_model", _dgn_operands),
    ("gat_local_model_slots", _gat_operands),
], ids=["gin", "gin-vn", "gcn", "pna", "dgn", "gat"])
def test_slots_kernel_matches_jax(name, ops, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = ops()
    jax_name, convert = _JAX_FORMS.get(name, (name, dict))
    expect = _jax_kernel(jax_name, convert(ops))
    got = getattr(local_layer, name)(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_gat_overflowing_non_edge_stays_finite():
    """The port of tests/test_local_layer.py::
    test_gat_dense_masked_exp_overflow_stays_finite: a non-edge pair whose
    raw score overflows exp, and the empty lanes of a row whose s_src does,
    contribute nothing; the output is finite and equals the benign run's."""
    hot = local_layer.gat_local_model_slots(**_port(_gat_overflow_operands(True), "cpu"))
    cold = local_layer.gat_local_model_slots(**_port(_gat_overflow_operands(False), "cpu"))
    assert bool(hot.isfinite().all())
    np.testing.assert_allclose(hot.numpy(), cold.numpy(), rtol=1e-6, atol=1e-6)


def test_gat_message_overflowing_empty_slot_stays_finite():
    """The sibling for row 21's plain version: empty slots of rows whose raw
    score overflows exp (100 against float32's 88.7) add nothing, with and
    without the divide; the output is finite and equals the benign run's.
    (The JAX ``gat_local_message_slots`` multiplies exp(raw) by the slot's
    validity and returns NaN there; ROADMAP queue 3.)"""
    for divide in (True, False):
        hot, cold = (
            local_layer.gat_local_message_slots(**_port(_gat_message_overflow_operands(h), "cpu"),
                                                divide=divide)
            for h in (True, False)
        )
        assert bool(hot.isfinite().all())
        torch.testing.assert_close(hot, cold, rtol=0, atol=0)


_GIN_SMALL = lambda: loaders.synthetic_gin_params(0, dim=16, hidden=32, layers=2)
_GCN_SMALL = lambda: loaders.synthetic_gcn_params(0, dim=16, layers=2)


@pytest.mark.parametrize("name,model,params,layout", [
    ("gin-vn", gin, _GIN_SMALL, "slot"),
    ("gcn", gcn, _GCN_SMALL, "slot"),
    ("pna", pna, lambda: loaders.synthetic_pna_params(0, dim=16, layers=2), "slot"),
    ("dgn", dgn, lambda: loaders.synthetic_dgn_params(0, dim=16, layers=2), "slot"),
    ("gat", gat, lambda: loaders.synthetic_gat_params(0, dim=16, heads=2, layers=2), "slot"),
    ("gin", gin, _GIN_SMALL, "ell"),
    ("gin-vn", gin, _GIN_SMALL, "ell"),
    ("gcn", gcn, _GCN_SMALL, "ell"),
], ids=["gin-vn", "gcn", "pna", "dgn", "gat", "gin-ell", "gin-vn-ell", "gcn-ell"])
@pytest.mark.parametrize("prec", [FLOAT32, BF16], ids=["f32", "bf16"])
def test_model_operands_meet_the_kernel_contract(name, model, params, layout, prec):
    """What a model's slot or ELL branch hands its kernel is what the CUDA
    wrapper accepts (it checks before launch, on the card only): every
    tensor contiguous, int32 indices, activations and weights in the
    compute dtype (GIN's eps_all in float32). The ELL batch's largest graph
    has 400 nodes (W=512)."""
    params = loaders.params_from_numpy(params(), prec, "cpu")
    if layout == "slot":
        ops = model.slot_kernel_operands(params, base.to_device(_slot_batch(name, 11), "cpu"), prec)
    else:
        ops = model.ell_kernel_operands(params, base.to_device(_ell_batch(name, 400, 11), "cpu"), prec)
        assert ops["window"] == 512
    for k, v in ops.items():
        if not torch.is_tensor(v):
            continue
        assert v.is_contiguous(), k
        if k in ("slot_meta", "slot_src", "slot_pstack", "ell_meta", "pool_gl"):
            assert v.dtype == torch.int32, k
        else:
            assert v.dtype == (torch.float32 if k == "eps_all" else prec.compute_dtype), k


@pytest.mark.parametrize("model", [pna, dgn, gat], ids=["pna", "dgn", "gat"])
@pytest.mark.parametrize("prec", [FLOAT32, BF16], ids=["f32", "bf16"])
def test_layer_operands_meet_the_kernel_contract(model, prec):
    """What the per-layer slot path of PNA, DGN and GAT hands its kernels
    (rows 19, 22, 21 and the spill scatter, row 24) on a spilling slot batch
    is what the CUDA wrappers accept: every tensor contiguous, int32
    indices, values in the compute dtype, the shapes the wrappers check."""
    name = model.__name__.rsplit(".", 1)[-1]
    small = {"pna": lambda: loaders.synthetic_pna_params(0, dim=16, layers=2),
             "dgn": lambda: loaders.synthetic_dgn_params(0, dim=16, layers=2),
             "gat": lambda: loaders.synthetic_gat_params(0, dim=16, heads=2, layers=2)}[name]
    params = loaders.params_from_numpy(small(), prec, "cpu")
    batch = base.to_device(_spill_batch(name, 11), "cpu")
    kernels = model.layer_kernel_operands(params, batch, prec)
    n = batch["node_feat"].shape[0]
    for kname, ops in kernels.items():
        for k, v in ops.items():
            if not torch.is_tensor(v):
                continue
            assert v.is_contiguous(), (kname, k)
            if k in ("slot_src", "slot_stack", "v_local", "block_window"):
                assert v.dtype == torch.int32, (kname, k)
            else:
                assert v.dtype == prec.compute_dtype, (kname, k)
    seg = kernels["windowed_segment_sum"]
    p = seg["values"].shape[0]
    assert seg["v_local"].shape == (p, 1) and p == seg["block_window"].shape[0] * 128
    assert seg["window"] * seg["num_windows"] >= n
    if name == "dgn":
        assert kernels["dgn_local_layer_slots"]["m_spill"].shape == (n, 32)
        assert kernels["dgn_local_layer_slots"]["b_post"].shape == (1, 16)
    if name == "gat":
        assert kernels["gat_local_message_slots"]["divide"] is False


@pytest.mark.parametrize("name,model,params,big", [
    ("gin", gin, _GIN_SMALL, 300), ("gin-vn", gin, _GIN_SMALL, 300),
    ("gcn", gcn, _GCN_SMALL, 300), ("gcn", gcn, _GCN_SMALL, 120),
], ids=["gin-spill", "gin-vn-spill", "gcn-spill", "gcn"])
@pytest.mark.parametrize("prec", [FLOAT32, BF16], ids=["f32", "bf16"])
def test_ell_layer_operands_meet_the_kernel_contract(name, model, params, big, prec):
    """What the per-layer ELL path of GIN, GIN-VN and GCN hands its kernels
    (rows 13, 14 or 15, and the spill scatter on a spill tail) is what the
    CUDA wrappers accept: every tensor contiguous, int32 lanes, values in
    the compute dtype (GIN's eps1 in float32), the shapes the wrappers
    check. A graph of 300 nodes at W=128 spills; one of 120 does not."""
    spec = registry.get(name)
    rng = np.random.default_rng(11)
    graphs = registry.apply_transforms(
        spec, synthetic_molhiv(6, seed=11) + [random_molecule_graph(rng, num_nodes=big)])
    packed = pack_graphs_aligned(graphs, window=128, node_capacity=1023, edge_capacity=4096,
                                 graph_capacity=16)
    batch = base.to_device(base.as_batch(packed, blocked="local_ell", window=128, block=384), "cpu")
    kernels = model.layer_kernel_operands(loaders.params_from_numpy(params(), prec, "cpu"), batch, prec)
    spill = big > 128
    want = {"gin": "gin_local_layer_ell", "gcn": "gcn_local_message_ell" if spill
            else "gcn_local_layer_ell"}[name.split("-")[0]]
    assert set(kernels) == ({want, "windowed_segment_sum"} if spill else {want})
    n, d = batch["node_feat"].shape[0], 16
    for kname, ops in kernels.items():
        for k, v in ops.items():
            if not torch.is_tensor(v):
                continue
            assert v.is_contiguous(), (kname, k)
            if k in ("ell_meta", "v_local", "block_window"):
                assert v.dtype == torch.int32, (kname, k)
            else:
                assert v.dtype == (torch.float32 if k == "eps1" else prec.compute_dtype), (kname, k)
    ops = kernels[want]
    assert ops["ell_meta"].shape == (batch["loc_ulocal"].shape[0], 5) and ops["h"].shape == (n, d)
    if name.startswith("gin"):
        assert ops["eps1"].shape == (1, 1) and ops["b1"].shape == (32,)
        assert (ops["m_spill"] is None) == (name == "gin" and not spill)
    elif not spill:
        assert ops["w_next"].shape == (d, d) and ops["root"].shape == (d,)
