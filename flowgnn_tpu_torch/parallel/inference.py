"""Sharded inference steps: data-parallel buckets × edge-partitioned graphs.

The counterpart of ``flowgnn_tpu.parallel.inference``. Each step factory returns
a step ``(params, stacked_batch) → [data, G+1, T]`` that every rank of a
``parallel.mesh.Mesh`` calls with the same stacked (numpy) batch, the way
the JAX package's ``shard_map`` step takes the global arrays. A rank takes
its ``[data_row]`` or ``[data_row, edge_shard]`` slice, moves it to its
device, runs the model with the mesh's edge axis as ``edge_axis``, and one
tiled all-gather over the data axis gives every rank all rows' predictions.

  * ``sharded_forward``: the replicated-node path. Each data row is one
    bucket (``stack_buckets``: plain edge-list batches), its node arrays
    whole on every rank of the row, its edge arrays (senders, receivers,
    edge_attr) split into ``edge`` contiguous slices; every segment
    reduction in the model gives partial node results that one all-reduce
    over the edge axis completes (``ops.segment``). The update matmuls run
    redundantly on each rank of a row. Every kernel is gated off there (the
    models' kernels run only on one device or on a halo shard), so each
    model runs its plain loop.
  * ``halo_forward``: the node-partitioned path (``parallel.halo``): each
    rank runs the model's halo branch on its shard: per layer one all-to-all
    of the boundary rows, plus one [G+1, D] all-reduce or one tiled
    all-gather of pool partials for the readout; its kernels run per shard.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.graphs import PackedGraphs
from ..core.numerics import FLOAT32, Precision
from ..models.base import as_batch, to_device
from .mesh import Mesh

# The edge arrays, split over the edge axis on the replicated-node path.
_EDGE_KEYS = ("senders", "receivers", "edge_attr")
# A halo batch's keys replicated over the edge axis; every other key has a
# leading rank axis.
_HALO_REPLICATED = ("n_node", "n_edge", "pool_row")


def stack_buckets(buckets: list[PackedGraphs]) -> dict:
    """Identically shaped packed buckets as plain batches, stacked along a
    leading data axis."""
    dicts = [as_batch(b) for b in buckets]
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def batch_specs(batch: dict) -> dict:
    """Each key's mesh axes, as the JAX ``PartitionSpec``s name them:
    ("data", "edge") for the edge arrays (their first axis after the data
    axis split over the edge axis), ("data",) for the rest."""
    return {k: ("data", "edge") if k in _EDGE_KEYS else ("data",) for k in batch}


def halo_batch_specs(batch: dict) -> dict:
    """Each key's mesh axes for a stacked halo batch: ("data",) for the
    replicated keys, ("data", "edge") (a leading rank axis) for the rest."""
    return {k: ("data",) if k in _HALO_REPLICATED else ("data", "edge") for k in batch}


def _local(batch: dict, specs: dict, mesh: Mesh, shards: bool) -> dict:
    """This rank's part of a stacked batch: each key's data row, and of a
    key split over the edge axis (``specs``) the rank's contiguous 1/edge
    share of the next axis; ``shards``: that axis lists the ranks' shards
    (a halo batch), so it must have the edge axis's size, and the rank's own
    is taken."""
    out = {}
    for k, v in batch.items():
        x = v[mesh.data.index]
        if "edge" in specs[k]:
            n, size, i = x.shape[0], mesh.edge.size, mesh.edge.index
            if (n != size) if shards else (n % size):
                raise ValueError(f"{k}: an axis of {n} does not split over {size} edge ranks")
            per = n // size
            x = x[i] if shards else x[i * per : (i + 1) * per]
        out[k] = x
    return out


def shard_slice(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a stacked replicated-node batch
    (``stack_buckets``): its data row, with the edge arrays cut to its
    contiguous 1/edge share."""
    return _local(batch, batch_specs(batch), mesh, shards=False)


def halo_shard_slice(batch: dict, mesh: Mesh) -> dict:
    """This rank's shard of a stacked halo batch (``stack_halo_buckets``):
    [data_row] of the replicated keys, [data_row, edge_index] of the rest."""
    return _local(batch, halo_batch_specs(batch), mesh, shards=True)


def _step(forward: Callable, mesh: Mesh, prec: Precision, slicer: Callable, fwd_kwargs: dict):
    def run(params: dict, batch: dict) -> torch.Tensor:
        for k, v in batch.items():
            if v.shape[0] != mesh.data.size:
                raise ValueError(f"{k}: leading axis {v.shape[0]}, mesh data axis "
                                 f"{mesh.data.size}")
        local = to_device(slicer(batch, mesh), mesh.device)
        out = forward(params, local, prec, edge_axis=mesh.edge, **fwd_kwargs)
        return mesh.data.all_gather(out[None])

    return run


def sharded_forward(forward: Callable, mesh: Mesh, prec: Precision = FLOAT32, **fwd_kwargs):
    """The replicated-node step: (params on the rank's device, a stacked
    batch from ``stack_buckets``) → [data, G+1, T] on every rank. The
    edge-capacity must divide by the edge axis's size."""
    return _step(forward, mesh, prec, shard_slice, fwd_kwargs)


def stack_halo_buckets(halo_batches: list[dict]) -> dict:
    """Per-bucket halo batch dicts (``parallel.halo.build_halo_batch``; one
    layout signature, ``halo_batches_uniform``) stacked along a leading
    data axis."""
    return {k: np.stack([d[k] for d in halo_batches]) for k in halo_batches[0]}


def halo_forward(forward: Callable, mesh: Mesh, prec: Precision = FLOAT32, **fwd_kwargs):
    """The halo step: (params on the rank's device, a stacked halo batch
    whose rank axis is the mesh's edge axis) → [data, G+1, T] on every
    rank. Each rank runs the model's halo branch on its shard
    (``models.base.halo_exchange``)."""
    return _step(forward, mesh, prec, halo_shard_slice, fwd_kwargs)
