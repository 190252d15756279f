"""The hand-written CUDA kernel against its plain torch version, on a card.

These tests skip without a CUDA device. The file imports no jax, so it runs
on a machine without it: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Its operand builder also serves ``test_torch_local_layer.py``.
"""

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.core.graphs import pack_graphs_aligned
from flowgnn_tpu_torch.core.synthetic import synthetic_molhiv
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.ops import local_layer

L, D, H, W = 2, 32, 64, 128


def _operands(vn: bool, seed: int = 11) -> dict:
    """Slot layout of 8 synthetic graphs plus seeded random h0 and weights,
    as numpy arrays."""
    spec = registry.get("gin-vn" if vn else "gin")
    graphs = registry.apply_transforms(spec, synthetic_molhiv(8, seed=seed))
    packed = pack_graphs_aligned(graphs, window=W, node_capacity=511,
                                 edge_capacity=1024, graph_capacity=16)
    batch = base.as_batch(packed, blocked="local_slots", window=W)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    n = batch["node_feat"].shape[0]
    slots = batch["slot_geom"].shape[-1]
    return dict(
        slot_meta=batch["slot_meta"], h0=f32(n, D), pool_gl=batch["pool_gl"],
        ee_tables=f32(L * 13, D), w1_all=f32(L * H, D), b1_all=f32(L, H),
        w2_all=f32(L * D, H), b2_all=f32(L, D),
        eps_all=(1 + f32(L, 1)).astype(np.float32), pred_w=f32(D, 1),
        window=W, slots=slots, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=base.slot_prefix_caps(batch, slots),
        vn_col=batch["vn_mask"].astype(np.float32) if vn else None,
    )


def _port(ops: dict, device, dtype=torch.float32) -> dict:
    out = {}
    for k, v in ops.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v).to(device)
            out[k] = t.to(dtype) if t.is_floating_point() and k != "eps_all" else t
        else:
            out[k] = v
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", [False, True], ids=["gin", "gin-vn"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_slots_cuda_kernel_matches_plain(vn, dtype, tol, cuda_device):
    """f32: the kernel and the plain version differ in summation order only;
    bf16: a rounding flip at one stage propagates through later layers."""
    ops = _port(_operands(vn), cuda_device, dtype)
    before = local_layer.gin_local_model_slots.launches
    got = local_layer.gin_local_model_slots(**ops)
    torch.cuda.synchronize()
    assert local_layer.gin_local_model_slots.launches == before + 1
    expect = local_layer.gin_local_model_slots_ref(**ops)
    torch.testing.assert_close(got, expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_slots_cuda_kernel_rejects_oversized_window(cuda_device):
    """A window whose state does not fit one block's shared memory raises
    before launch instead of failing inside the kernel."""
    d = 100
    n, window = 256, 256
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(cuda_device)
    ops = dict(
        slot_meta=torch.full((window, 4), -1, dtype=torch.int32, device=cuda_device),
        h0=t(n, d), pool_gl=torch.zeros(window, dtype=torch.int32, device=cuda_device),
        ee_tables=t(L * 13, d), w1_all=t(L * 2 * d, d), b1_all=t(L, 2 * d),
        w2_all=t(L * d, 2 * d), b2_all=t(L, d), eps_all=t(L, 1), pred_w=t(d, 1),
        window=window, slots=1, num_layers=L, gmax=base.POOL_GMAX,
        prefix_caps=(window,),
    )
    before = local_layer.gin_local_model_slots.launches
    with pytest.raises(ValueError, match="shared memory"):
        local_layer.gin_local_model_slots(**ops)
    assert local_layer.gin_local_model_slots.launches == before
