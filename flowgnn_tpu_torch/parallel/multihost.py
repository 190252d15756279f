"""Multi-host (multi-process) distribution — SURVEY.md §7.6.

The counterpart of ``flowgnn_tpu.parallel.multihost``. Two tiers:

  * within a host: the data × edge mesh of ``parallel.mesh``, whose ranks
    are this host's processes, their per-layer collectives on this host;
  * across hosts: one process per host, joined in a ``torch.distributed``
    process group (gloo, CPU tensors). Graph streams are dealt to hosts at
    bucket granularity; the one collective across hosts is the all-gather
    of the per-bucket predictions (``gather_results``).

``initialize`` joins a host into the cluster (no-op for one process),
``global_mesh`` lays the ranks of all hosts out as a data × edge grid with
each edge group inside one host, ``shard_stream`` deals the buckets to this
host and ``gather_results`` reassembles every host's rows.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Axis


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or skip joining) the multi-host cluster.

    Resolution order: explicit arguments → FLOWGNN_COORDINATOR (host:port)
    / FLOWGNN_NUM_PROCESSES / FLOWGNN_PROCESS_ID → the environment
    ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), the
    counterpart of ``jax.distributed``'s detection of a cluster. Joins with
    the gloo backend (the hosts exchange only CPU tensors) and returns True;
    returns False for a single process, which then runs as before."""
    coordinator_address = coordinator_address or os.environ.get("FLOWGNN_COORDINATOR")
    if num_processes is None and "FLOWGNN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FLOWGNN_NUM_PROCESSES"])
    if process_id is None and "FLOWGNN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FLOWGNN_PROCESS_ID"])
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-host run needs the coordinator address, the number "
                             "of processes and this process's id")
        if dist.is_initialized():
            return True
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return True
    if "MASTER_ADDR" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://")
        return True
    return False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(edge: int = 1, local_ranks: int = 1, hosts: Optional[int] = None) -> np.ndarray:
    """The [data, edge] grid of global rank ids over ``hosts`` hosts of
    ``local_ranks`` ranks each (host h holds ranks h·local_ranks onward):
    each edge group is filled from one host's local ranks, so the per-layer
    collectives stay inside a host and only the data axis spans hosts.
    ``edge`` must divide the local ranks (``ValueError`` otherwise)."""
    hosts = process_count() if hosts is None else hosts
    if edge > 1 and local_ranks % edge != 0:
        raise ValueError(
            f"edge={edge} does not divide the {local_ranks} local devices — "
            "edge-axis collectives would cross hosts"
        )
    total = hosts * local_ranks
    data = total // edge
    return np.arange(data * edge).reshape(data, edge)


def shard_stream(buckets: Sequence, local_data: int = 1) -> tuple[list, list[int]]:
    """This host's share of the bucket stream, grouped for its local mesh.

    Buckets are dealt round-robin across hosts (every host calls this with
    the same stream), then grouped into ``local_data``-sized stacks for the
    host's data axis. Returns ``(groups, real_counts)``: a trailing partial
    group is padded by repeating its last bucket, and ``real_counts[i]``
    says how many of group i's rows are real, so that every submitted
    bucket is accounted for once."""
    mine = list(buckets[process_index() :: process_count()])
    groups, real = [], []
    for i in range(0, len(mine), local_data):
        g = list(mine[i : i + local_data])
        real.append(len(g))
        while len(g) < local_data:
            g.append(g[-1])
        groups.append(g)
    return groups, real


def gather_results(local_out: np.ndarray) -> np.ndarray:
    """Every host's result rows on every host: one all-gather of the
    [rows, G+1, T] predictions (each host the same shape) →
    [hosts, rows, G+1, T]; a single process returns ``local_out``."""
    if process_count() == 1:
        return np.asarray(local_out)
    hosts = Axis("host", process_count(), process_index(), dist.group.WORLD)
    x = torch.from_numpy(np.ascontiguousarray(local_out))
    return hosts.all_gather(x[None]).numpy()
