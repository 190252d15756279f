"""The device mesh of the sharded paths, on ``torch.distributed``.

The counterpart of ``flowgnn_tpu.parallel.mesh``: ranks laid out as a
``data`` × ``edge`` grid, rank r at row r // edge and column r % edge.

  * ``data``: whole packed buckets per rank, no communication in the
    forward (throughput scaling);
  * ``edge``: one bucket's edges, or its node shards, split over the ranks
    of one data row, their partial results combined by collectives.

Each rank holds one ``Axis`` object per mesh axis: the axis's name (the JAX
mesh's, ``"data"`` or ``"edge"``), its size, this rank's index along it and
the process group of the ranks that share this rank's other coordinate. The
models take the edge axis as their ``edge_axis``. The sharded paths use three
collectives, all methods of ``Axis`` and nowhere else in the port: one
all-to-all of the [k, H, D] boundary rows (``all_to_all``), one all-reduce
with SUM, MIN or MAX (``all_reduce``) and one tiled all-gather
(``all_gather``).

The transport is chosen by one rule (``transport``): NCCL when every rank of
the mesh has a GPU of its own, gloo otherwise (CPU ranks, or ranks that
share one GPU, which NCCL refuses). gloo has no all-to-all or all-gather on
CUDA tensors, so under gloo a device tensor is copied to the CPU for the
collective and back. The choice and its reason are printed by rank 0. A
failure of either transport raises; there is no fallback.

Each collective runs inside a ``torch.profiler.record_function`` span named
``<axis>.<collective>`` (``edge.all_to_all``, and ``edge.all_to_all.wait``
for the wait of an issued one), staging copies included, so that a trace
(``bench.profiling.trace``) splits a step's host time into collectives and
the rest. A span costs host time even when no profiler runs, so it is
entered only while one does (``_span``).

Ranks run as threads of one process (``run_threads``, over a ``HashStore``:
the CPU tests) or as spawned processes (``run_processes``, over a
``TCPStore`` on localhost).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as queue_mod
import sys
import threading
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

DEFAULT_TIMEOUT = timedelta(seconds=300)
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def transport(devices: Sequence) -> tuple[str, str]:
    """(backend, reason) for ranks on ``devices`` (one per rank, all of one
    host): "nccl" when every rank has a CUDA device of its own, else
    "gloo"."""
    devs = [torch.device(d) for d in devices]
    if not all(d.type == "cuda" for d in devs):
        return "gloo", "a rank is on the CPU"
    idx = [torch.cuda.current_device() if d.index is None else d.index for d in devs]
    if len(set(idx)) < len(idx):
        return "gloo", f"{len(idx)} ranks share {len(set(idx))} GPU(s); NCCL takes one rank a GPU"
    return "nccl", f"{len(idx)} ranks, each on a GPU of its own"


def _span(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs, else
    a no-op context."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return record_function(name)
    return contextlib.nullcontext()


class Axis:
    """One mesh axis as this rank sees it: ``name``, ``size``, this rank's
    ``index`` along it and ``group``, the process group of its ranks (None
    for an axis of one rank with no group: every collective is then the
    identity). ``staged``: copy CUDA tensors to the CPU for each
    collective (gloo)."""

    def __init__(self, name: str, size: int, index: int, group=None, staged: bool = False):
        self.name, self.size, self.index = name, size, index
        self.group, self.staged = group, staged

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, {self.index}/{self.size})"

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous().cpu() if self.staged else x.contiguous()

    def all_to_all(self, send: torch.Tensor, wait: bool = True):
        """[size, ...] → [size, ...]: block j of ``send`` goes to rank j,
        block j of the result came from rank j. With ``wait=False`` the
        collective is issued and a callable returned that waits for it and
        gives the result."""
        if self.group is None:
            return send if wait else (lambda: send)
        with _span(f"{self.name}.all_to_all"):
            x = self._in(send)
            out = torch.empty_like(x)
            work = self.group.alltoall_base(out, x, [], [], dist.AllToAllOptions())

        def finish() -> torch.Tensor:
            with _span(f"{self.name}.all_to_all.wait"):
                work.wait()
                return out.to(send.device)

        return finish() if wait else finish

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum", "min" or "max") of ``x`` over the
        axis's ranks (in place where nothing is staged)."""
        if self.group is None:
            return x
        with _span(f"{self.name}.all_reduce"):
            y = self._in(x)
            opts = dist.AllreduceOptions()
            opts.reduceOp = _OPS[op]
            self.group.allreduce([y], opts).wait()
            return y.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[m, ...] on each rank → [size·m, ...], the ranks' blocks in order
        (the JAX ``all_gather(..., tiled=True)``)."""
        if self.group is None:
            return x
        with _span(f"{self.name}.all_gather"):
            y = self._in(x)
            out = y.new_empty((self.size * y.shape[0],) + tuple(y.shape[1:]))
            self.group._allgather_base(out, y).wait()
            return out.to(x.device)


@dataclasses.dataclass
class Mesh:
    """This rank's view of the data × edge mesh."""

    data: Axis
    edge: Axis
    rank: int
    device: torch.device
    transport: str

    def barrier(self) -> None:
        """Return once every rank of the mesh has called it (an all-reduce
        over each axis)."""
        token = torch.zeros(1, device=self.device)
        self.edge.all_reduce(token)
        self.data.all_reduce(token)


def make_mesh(data: int = 1, edge: int = 1, *, rank: int = 0, store=None,
              devices: Optional[Sequence] = None, timeout: timedelta = DEFAULT_TIMEOUT,
              log: bool = True, name: str = "mesh") -> Mesh:
    """Rank ``rank``'s view of a ``data`` × ``edge`` mesh. ``devices``: each
    rank's device (default all CPU); ``store``: a ``torch.distributed``
    store all ranks share (needed for more than one rank; with one rank and
    no store the axes have no group). The edge axis's group is the ranks of
    this rank's data row, the data axis's those of its edge column, each
    made over its own prefix of ``store`` with the backend ``transport``
    picks (printed by rank 0 when ``log``). ``name`` keeps the keys of
    meshes made over one store apart."""
    world = data * edge
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a {data}x{edge} mesh")
    devices = [torch.device(d) for d in (devices or ["cpu"] * world)]
    if len(devices) != world:
        raise ValueError(f"mesh {data}x{edge} needs {world} devices, got {len(devices)}")
    if store is None and world > 1:
        raise ValueError(f"mesh {data}x{edge}: {world} ranks need a shared store")
    backend, reason = transport(devices)
    device = devices[rank]
    if log and rank == 0:
        print(f"# mesh {data}x{edge}: transport {backend} ({reason})", file=sys.stderr)
    if backend == "nccl":
        torch.cuda.set_device(device)
    row, col = divmod(rank, edge)

    def group(axis_name: str, key: int, index: int, size: int):
        if store is None:
            return None
        prefix = dist.PrefixStore(f"{name}/{axis_name}{key}/", store)
        if backend == "nccl":
            return dist.ProcessGroupNCCL(prefix, index, size)
        # The mesh's ranks share this host: gloo over the loopback device.
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
        opts._timeout = timeout
        return dist.ProcessGroupGloo(prefix, index, size, opts)

    staged = backend == "gloo" and device.type == "cuda"
    return Mesh(
        data=Axis("data", data, row, group("data", col, row, data), staged),
        edge=Axis("edge", edge, col, group("edge", row, col, edge), staged),
        rank=rank, device=device, transport=backend,
    )


def run_threads(fn: Callable, world: int, *args) -> list:
    """``fn(rank, store, *args)`` for every rank, each in a thread of this
    process, the ranks sharing one ``HashStore``: the results in rank order.
    The first rank that raises has its exception raised here, after every
    thread has ended (a rank stuck in a collective ends at the group's
    timeout)."""
    store = dist.HashStore()
    results: list = [None] * world
    errors: list = [None] * world

    def body(rank: int) -> None:
        try:
            results[rank] = fn(rank, store, *args)
        except Exception as e:  # re-raised in the caller
            errors[rank] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _child(rank: int, port: int, fn: Callable, args: tuple, out) -> None:
    try:
        store = dist.TCPStore("127.0.0.1", port, world_size=None, is_master=False,
                              timeout=DEFAULT_TIMEOUT)
        out.put((rank, True, fn(rank, store, *args)))
    except Exception:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_processes(fn: Callable, world: int, *args, timeout: float = 900.0) -> list:
    """``fn(rank, store, *args)`` for every rank, each in a spawned process
    (``torch.multiprocessing``, start method "spawn": the parent may hold a
    CUDA context), the ranks sharing a ``TCPStore`` whose server runs in
    this process on a free localhost port. ``fn`` and ``args`` must pickle
    (a module-level function) and ``fn`` should return host data (numpy),
    not CUDA tensors. Returns the results in rank order; a rank that raises
    or dies raises ``RuntimeError`` here with its traceback. Every process
    is ended before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, world_size=None, is_master=True,
                          timeout=DEFAULT_TIMEOUT, wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, store.port, fn, args, out))
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        waited = 0.0
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or waited > timeout:
                    what = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}" \
                        if dead else f"ranks timed out after {timeout:.0f} s"
                    raise RuntimeError(f"run_processes: {what}")
                continue
            if not ok:
                raise RuntimeError(f"run_processes: rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def rank_devices(world: int, device) -> list:
    """Each of ``world`` ranks' device on one host: the CPU for a CPU
    ``device``; for CUDA, rank r on GPU r mod the visible GPUs."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * world
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(world)]


def cpu_threads(world: int) -> None:
    """Share this host's cores among ``world`` CPU ranks of one process
    tree (torch's intra-op threads)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
