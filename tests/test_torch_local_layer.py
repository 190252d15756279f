"""The port's gin_local_model_slots (on the CPU: its plain version) against
the JAX Pallas kernel in interpret mode, on identical operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.ops import local_layer
from test_torch_cuda import _operands, _port


@pytest.mark.parametrize("vn", [False, True], ids=["gin", "gin-vn"])
def test_slots_kernel_matches_jax(vn, monkeypatch):
    from flowgnn_tpu.ops.pallas.local_layer import gin_local_model_slots as jax_kernel

    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _operands(vn)
    expect = np.asarray(jax_kernel(**{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()
    }))
    got = local_layer.gin_local_model_slots(**_port(ops, "cpu"))
    assert got.dtype == torch.float32 and got.shape == expect.shape
    assert np.abs(expect).max() > 1e-2  # the pool is not trivially zero
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)
