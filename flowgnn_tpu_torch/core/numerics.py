"""Numerics policy over torch dtypes.

The counterpart of ``flowgnn_tpu.core.numerics.Precision`` for the float
modes: f32, f64 (exactness tests) and bf16 (the bench default). The ap_fixed
emulation mode (``FixedSpec`` and the stage-boundary quantizer ``q``) is not
ported yet (ROADMAP queue 1 item 10): a ``Precision`` with ``fixed`` set
raises, and in the float modes ``q`` is the identity, so the port's models
leave it out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """``compute_dtype`` is the dense-math dtype; ``fixed`` would select the
    ap_fixed emulation ladder, which the port does not have yet."""

    compute_dtype: torch.dtype = torch.float32
    fixed: Optional[Any] = None

    def __post_init__(self):
        if self.fixed is not None:
            raise NotImplementedError(
                "ap_fixed emulation is not ported yet (ROADMAP queue 1 item 10)"
            )
        if self.compute_dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {self.compute_dtype}")


FLOAT32 = Precision()
FLOAT64 = Precision(compute_dtype=torch.float64)
BF16 = Precision(compute_dtype=torch.bfloat16)
