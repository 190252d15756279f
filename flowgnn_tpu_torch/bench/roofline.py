"""Roofline accounting on the port's card.

The counterpart of ``flowgnn_tpu/bench/roofline.py``'s ``ChipSpec`` and
``Cost``, with the NVIDIA H100 SXM as the default chip: dense bf16 on the
tensor cores, float32 outside them, dense int8 on the tensor cores and the
HBM3 rate (NVIDIA's data sheet; the card's own power limit, which
``nvidia-smi`` reads, may hold it below them). A light-speed time is the
larger of the operations over the peak for their type and the bytes over
the memory rate.

Not carried over yet: ``model_cost`` and ``report``, whose per-model counts
wait for an audit (the JAX package's put PNA at 115% of light speed), and
the JAX module's shape-ceiling tables, which are TPU measurements;
``python -m flowgnn_tpu_torch.bench.matmul_shapes`` measures the card's own.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "h100-sxm"
    peak_bf16_flops: float = 989e12
    peak_f32_flops: float = 67e12
    hbm_gbps: float = 3.35e12  # bytes per second, named as in the JAX package
    peak_int8_ops: float = 1979e12


H100 = ChipSpec()


@dataclasses.dataclass
class Cost:
    flops: float
    bytes: float

    def light_speed_s(self, chip: ChipSpec = H100, bf16: bool = True) -> float:
        peak = chip.peak_bf16_flops if bf16 else chip.peak_f32_flops
        return max(self.flops / peak, self.bytes / chip.hbm_gbps)

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)
