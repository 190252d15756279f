"""The port runs without jax: in a fresh interpreter where ``import jax`` and
``import ml_dtypes`` fail, every module of flowgnn_tpu_torch imports and the
GIN / GIN-VN slice runs on the CPU."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import importlib, pkgutil
import flowgnn_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(flowgnn_tpu_torch.__path__, "flowgnn_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k == "flowgnn_tpu" or k.startswith("flowgnn_tpu.") for k in sys.modules)

from flowgnn_tpu_torch.core.graphs import pack_dataset
from flowgnn_tpu_torch.core.numerics import FLOAT32
from flowgnn_tpu_torch.core.synthetic import synthetic_dataset
from flowgnn_tpu_torch.models import base, registry
from flowgnn_tpu_torch.ops import local_layer
from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

for name in ("gin", "gin-vn"):
    spec = registry.get(name)
    graphs = registry.apply_transforms(spec, synthetic_dataset("molhiv", seed=0, num_graphs=24))
    w, _ = base.choose_geometry(name, max(g.num_nodes for g in graphs))
    buckets = list(pack_dataset(graphs, node_capacity=255, edge_capacity=1024,
                                graph_capacity=16, align_window=w))
    batches = base.as_batches_uniform(buckets, blocked="local_slots", window=w)
    params = params_from_numpy(synthetic_gin_params(0, dim=16, hidden=32, layers=2), FLOAT32, "cpu")
    for packed, batch in zip(buckets, batches):
        out = spec.forward(params, base.to_device(batch, "cpu"), FLOAT32)
        assert out.shape == (packed.n_node.shape[0], 1) and bool(out.isfinite().all())
print("ok", len(mods))
"""


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=root, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok "), proc.stdout
    assert int(proc.stdout.split()[1]) >= 14  # every module was walked
