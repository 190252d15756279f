"""Numerics policy over torch dtypes, with the reference's ``ap_fixed``
emulation.

The counterpart of ``flowgnn_tpu.core.numerics``. The reference computes in
``ap_fixed<16,6>`` (GIN / GCN / GAT / PNA, GIN/src/dcl.h:58-59) or
``ap_fixed<16,3>`` (DGN, DGN/src/dcl.h:54-55): 16-bit signed fixed point
with 6 (resp. 3) integer bits, a value grid of 2^-10 (resp. 2^-13) and a
range of ±32 (resp. ±4), quantized by truncation toward −∞ (AP_TRN).

The modes form a tolerance ladder:

  * the float modes: f32, f64 (exactness tests) and bf16 (the bench
    default), where ``Precision.q`` is the identity and costs nothing;
  * the fixed mode (``Precision(fixed=...)``, ``FIXED_16_6`` /
    ``FIXED_16_3``): weights snapped to the grid on load
    (``params.loaders.params_from_numpy``) and activations re-quantized at
    every logical stage boundary (``q``). It reproduces the reference's
    quantization envelope without replaying its accumulation order.
    Overflow saturates (``"sat"``, the default) or wraps (``"wrap"``,
    AP_WRAP fidelity). Every hand-written kernel is gated off in this mode,
    as in the JAX package: the models run their plain loop, whose message
    sums on an edge-block batch go through the windowed scatter (kernel
    table row 24).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedSpec:
    """ap_fixed<width, int_bits> grid."""

    width: int = 16
    int_bits: int = 6
    overflow: Literal["sat", "wrap"] = "sat"

    @property
    def frac_bits(self) -> int:
        return self.width - self.int_bits

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def max_val(self) -> float:
        """Largest representable value ((2^(W-1)-1) / 2^f)."""
        return ((1 << (self.width - 1)) - 1) / self.scale

    @property
    def min_val(self) -> float:
        return -(1 << (self.width - 1)) / self.scale

    @property
    def epsilon(self) -> float:
        """ap_fixed_epsilon<T>() = one ulp (GIN/src/util.h:27-32)."""
        return 1.0 / self.scale

    def quantize_np(self, x: np.ndarray) -> np.ndarray:
        """Snap to the grid on the host: floor in f64 (no f32 cast first, as
        the JAX package does it), clip or wrap, f32 out."""
        q = np.floor(np.asarray(x, np.float64) * self.scale)
        lo, hi = -(1 << (self.width - 1)), (1 << (self.width - 1)) - 1
        if self.overflow == "sat":
            q = np.clip(q, lo, hi)
        else:
            q = np.mod(q - lo, 1 << self.width) + lo
        return (q / self.scale).astype(np.float32)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Snap a tensor to the grid, f32 out whatever ``x``'s dtype: cast to
        f32, floor(x·scale) in f32, clip (sat) or wrap by floor-mod, divide
        by the scale; bit for bit the JAX package's ``quantize``."""
        q = torch.floor(x.to(torch.float32) * self.scale)
        lo, hi = float(-(1 << (self.width - 1))), float((1 << (self.width - 1)) - 1)
        if self.overflow == "sat":
            q = torch.clamp(q, lo, hi)
        else:
            q = torch.remainder(q - lo, float(1 << self.width)) + lo
        return q / self.scale


AP_FIXED_16_6 = FixedSpec(16, 6)
AP_FIXED_16_3 = FixedSpec(16, 3)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``compute_dtype`` is the dense-math dtype; ``fixed`` selects the
    ap_fixed emulation ladder."""

    compute_dtype: torch.dtype = torch.float32
    fixed: Optional[FixedSpec] = None

    def __post_init__(self):
        if self.compute_dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {self.compute_dtype}")

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize a stage-boundary activation; in the float modes ``x``
        itself (no copy, no launch)."""
        if self.fixed is None:
            return x
        return self.fixed.quantize(x)

    def q_np(self, x: np.ndarray) -> np.ndarray:
        if self.fixed is None:
            return np.asarray(x, np.float32)
        return self.fixed.quantize_np(x)


FLOAT32 = Precision()
FLOAT64 = Precision(compute_dtype=torch.float64)
BF16 = Precision(compute_dtype=torch.bfloat16)
FIXED_16_6 = Precision(fixed=AP_FIXED_16_6)
FIXED_16_3 = Precision(fixed=AP_FIXED_16_3)
