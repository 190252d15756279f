"""flowgnn_tpu_torch — the PyTorch / CUDA port of flowgnn_tpu for NVIDIA Hopper.

Batched GNN inference over packed molecular graphs, module for module beside
the JAX package ``flowgnn_tpu`` (which stays the reference it is tested
against). Imports torch and numpy only; kernels are built from ``csrc/`` on
first use, never at import.
"""

__version__ = "0.1.0"

from .core.numerics import FIXED_16_3, FIXED_16_6, FLOAT32, Precision  # noqa: F401,E402
