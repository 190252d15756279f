"""Segment primitives over a packed edge or node axis.

``segment_sum`` is the counterpart of ``flowgnn_tpu.ops.segment.segment_sum``
on one device. ``segment_max`` / ``segment_min`` come with the PNA slice, and
the cross-device ``axis_name`` variants with ``parallel/`` (ROADMAP queue 1
item 13).
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = Σ_{i: segment_ids[i] = s} data[i], in ``data``'s dtype.
    Ids must lie in [0, num_segments); on CUDA the order of the sum varies
    from run to run (atomics)."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, segment_ids.long(), data)
