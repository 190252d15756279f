"""The port's slot megakernels (on the CPU: their plain versions) against
the JAX Pallas kernels in interpret mode, on identical operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.ops import local_layer
from test_torch_cuda import _gcn_operands, _operands, _pna_operands, _port


def _jax_kernel(name: str, ops: dict) -> np.ndarray:
    from flowgnn_tpu.ops.pallas import local_layer as jax_local_layer

    return np.asarray(getattr(jax_local_layer, name)(**{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()
    }))


@pytest.mark.parametrize("name,ops", [
    ("gin_local_model_slots", lambda: _operands(False)),
    ("gin_local_model_slots", lambda: _operands(True)),
    ("gcn_local_model_slots", _gcn_operands),
    ("pna_local_model", _pna_operands),
], ids=["gin", "gin-vn", "gcn", "pna"])
def test_slots_kernel_matches_jax(name, ops, monkeypatch):
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = ops()
    expect = _jax_kernel(name, ops)
    got = getattr(local_layer, name)(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)
