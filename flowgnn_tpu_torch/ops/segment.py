"""Segment primitives over a packed edge or node axis.

The counterparts of ``flowgnn_tpu.ops.segment`` on one device; the
cross-device ``axis_name`` variants come with ``parallel/`` (ROADMAP queue 1
item 13).
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = Σ_{i: segment_ids[i] = s} data[i], in ``data``'s dtype.
    Ids must lie in [0, num_segments). Floats narrower than f32 are summed
    in f32 and rounded once, as the CPU's ``index_add_`` does: on CUDA its
    atomics round every add to the data's dtype, so a bf16 sum of a few
    hundred rows stops growing. On CUDA the order of the sum varies from
    run to run (atomics)."""
    acc = data.dtype
    if data.is_floating_point() and torch.finfo(acc).bits < 32:
        acc = torch.float32
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    return out.index_add_(0, segment_ids.long(), data.to(acc)).to(data.dtype)


def _segment_reduce(data, segment_ids, num_segments, init, reduce):
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), init, dtype=data.dtype,
        device=data.device,
    )
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=True)


def segment_min(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, init: float
) -> torch.Tensor:
    """Running min with a finite seed, as the reference's fixed-point
    accumulator starts (PNA/src/message_passing.cc reset_message):
    out[s] = min(init, min over segment s); an empty segment stays at
    ``init`` (rounded to ``data``'s dtype)."""
    return _segment_reduce(data, segment_ids, num_segments, init, "amin")


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, init: float
) -> torch.Tensor:
    """out[s] = max(init, max over segment s); empty segments stay at
    ``init``."""
    return _segment_reduce(data, segment_ids, num_segments, init, "amax")
