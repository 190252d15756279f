"""Roofline accounting on the port's card.

The counterpart of ``flowgnn_tpu/bench/roofline.py``'s ``ChipSpec`` and
``Cost``, with the NVIDIA H100 SXM as the default chip: dense bf16 on the
tensor cores, float32 outside them, dense int8 on the tensor cores and the
HBM3 rate (NVIDIA's data sheet; the card's own power limit, which
``nvidia-smi`` reads, may hold it below them). A light-speed time is the
larger of the operations over the peak for their type and the bytes over
the memory rate.

``model_cost``, ``spmm_cost`` and ``report`` keep the JAX module's counts
(per model and bucket: its dense products and a few lane terms a layer, at
the reference's widths), so a ratio on the card and one on the TPU count the
same work; ``chip_smoke.py:work`` counts each kernel's own work, and PERF.md
lists where the two differ. The JAX module's shape-ceiling tables are TPU
measurements and are not carried over; ``python -m
flowgnn_tpu_torch.bench.matmul_shapes`` measures the card's own.
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


def _mm(n: int, k: int, m: int, b: int) -> Cost:
    """n×k @ k×m matmul cost at b bytes/elem (weights assumed resident)."""
    return Cost(2.0 * n * k * m, b * (n * k + n * m))


def model_cost(name: str, num_nodes: int, num_edges: int, bytes_per_el: int = 2) -> Cost:
    """Per-bucket forward cost, the JAX module's counts. Dims/layers per
    SURVEY.md §2.5."""
    n, e, b = num_nodes, num_edges, bytes_per_el
    if name in ("gin", "gin-vn"):
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 100, 200, b) + _mm(n, 200, 100, b)
            c += Cost(3 * e * 100, b * (3 * e * 100 + n * 100))  # msg+scatter
        return c
    if name == "gcn":
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 100, 100, b)
            c += Cost(4 * e * 100, b * (3 * e * 100 + n * 100))
        return c
    if name == "gat":
        c = Cost(0, 0)
        for _ in range(5):
            c += _mm(n, 64, 64, b)  # linear projection (4 heads × 16 flat)
            c += _mm(n, 64, 64, b)  # skip projection
            c += Cost(5 * e * 64, b * (3 * e * 64 + n * 64))
        return c
    if name == "pna":
        c = Cost(0, 0)
        for _ in range(4):
            c += _mm(n, 12 * 80, 80, b)
            c += Cost(6 * e * 80, b * (4 * e * 80 + 4 * n * 80))
        return c
    if name == "dgn":
        c = Cost(0, 0)
        for _ in range(4):
            c += _mm(n, 200, 100, b)
            c += Cost(5 * e * 100, b * (3 * e * 100 + 2 * n * 100))
        return c
    raise KeyError(name)


def spmm_cost(padded_lanes: int, window: int, dim: int, bytes_per_el: int = 2) -> Cost:
    """The JAX module's windowed one-hot scatter cost (one [block, window]ᵀ
    @ [block, dim] product per block). The port's kernels gather by index
    and do none of it; kept so the two packages' figures can be compared."""
    return Cost(2.0 * padded_lanes * window * dim, bytes_per_el * padded_lanes * dim)


def report(name: str, num_nodes: int, num_edges: int, measured_s: float,
           bf16: bool = True, chip: ChipSpec = H100) -> dict:
    """``model_cost`` of a stream against ``measured_s`` seconds a pass on
    ``chip``: GFLOP, GB, the light-speed and measured µs, the roofline
    fraction (light speed over measured) and the achieved TFLOP/s."""
    cost = model_cost(name, num_nodes, num_edges, 2 if bf16 else 4)
    ideal = cost.light_speed_s(chip, bf16)
    return {
        "gflops": cost.flops / 1e9,
        "gbytes": cost.bytes / 1e9,
        "light_speed_us": ideal * 1e6,
        "measured_us": measured_s * 1e6,
        "roofline_frac": ideal / measured_s if measured_s > 0 else 0.0,
        "achieved_tflops": cost.flops / measured_s / 1e12 if measured_s else 0.0,
    }
