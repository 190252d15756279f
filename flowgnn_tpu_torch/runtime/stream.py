"""Inference stream runner: the host application layer.

The counterpart of ``flowgnn_tpu/runtime/stream.py``. One enqueue processes a
stream of graphs whose active weight set may change at any graph boundary
(the reference's ``reload_weights`` flag walks a packed array of weight
sets, GIN/src/GIN_compute.cc:49-63; GIN/src/host.cc:133 sets it for g==1).
Graphs are packed into static buckets that never span a weight-set boundary,
each bucket in the same window-aligned layouts as the bench entry (slots
where the bucket fits its window, and for PNA, GAT and DGN always; ELL
otherwise), so the whole-model kernels (rows 1-5) run one launch a bucket.
Predictions come back in submission order, one float per graph (the
HLS_output.txt contract, GIN/src/host.cc:213-222).

Where the JAX stream compiles one program per bucket signature with
``jax.jit``, this one captures one CUDA graph per (``batch_signature``,
weight set) on the card: the forward runs eagerly once (so that launch
plans, packed weight chunks and shared-memory opt-ins are made outside the
capture), is captured, and every later bucket of that signature and set
replays it. A bucket reaches the graph through static device inputs: its
host arrays go, in the worker threads, into one pinned buffer laid out by the
signature (``pack_inputs``); on the compute stream one host-to-device copy
brings that buffer into the signature's static inputs, the graph replays, and
``preds[:n, 0]`` goes into pinned host memory before any later replay. A
forward that cannot be captured raises, naming the model and the signature:
on the card there is no eager fallback. The weight chunks a graph reads are held with it (``ops.local_layer.
hold_packs``), so that the chunk cache's eviction cannot free them; the
stream's weights are its own and never change in place. On the CPU (the
tests) each bucket's forward runs eagerly.

The JAX stream's two faults are not copied: the slot pins are read, merged
and written under a lock (``_make_batch`` runs in worker threads), and the
int8 downcast of the categorical features checks their range and raises on
a value that does not fit.
"""

from __future__ import annotations

import collections
import functools
import itertools
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from ..core.graphs import Graph, pack_graphs_aligned
from ..core.numerics import FLOAT32, Precision
from ..models import registry
from ..models.base import as_batch, batch_signature, choose_geometry, to_device
from ..ops import local_layer
from ..params.loaders import params_from_numpy
from . import native

ALIGN = 256  # byte alignment of each array in a bucket's input buffer
INT8_KEYS = ("node_feat", "edge_attr")  # categorical features sent as int8


@functools.lru_cache(maxsize=None)
def input_layout(sig: tuple) -> tuple[tuple, int]:
    """The byte layout of a batch of signature ``sig`` in one buffer: per
    array (key, shape, numpy dtype, offset, bytes) in the signature's order,
    each offset a multiple of ``ALIGN``; and the buffer's length."""
    out, off = [], 0
    for key, shape, dtype in sig:
        nbytes = math.prod(shape) * np.dtype(dtype).itemsize
        out.append((key, tuple(shape), np.dtype(dtype), off, nbytes))
        off += -(-nbytes // ALIGN) * ALIGN
    return tuple(out), max(off, ALIGN)


def pack_inputs(batch: dict, sig: tuple, pin: bool) -> torch.Tensor:
    """``batch``'s arrays copied into one uint8 host buffer laid out by
    ``input_layout(sig)``, pinned if ``pin``."""
    layout, total = input_layout(sig)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for key, shape, dtype, off, nbytes in layout:
        host[off:off + nbytes].view(dtype).reshape(shape)[...] = batch[key]
    return buf


def input_views(buf: torch.Tensor, sig: tuple) -> dict:
    """The batch dict over ``buf`` (laid out by ``input_layout(sig)``): one
    view per array, on ``buf``'s device."""
    layout, _ = input_layout(sig)
    return {key: buf[off:off + nbytes].view(torch.from_numpy(np.empty(0, dtype)).dtype)
            .view(shape) for key, shape, dtype, off, nbytes in layout}


def describe(model: str, sig: tuple) -> str:
    """A signature in words: the model, the layout, the window, the node
    rows and the arrays."""
    shapes = {k: s for k, s, _ in sig}
    layout = ("local_slots" if "slot_src" in shapes else
              "local_ell" if "loc_ell" in shapes else "plain")
    window = shapes["slot_geom"][0] if "slot_geom" in shapes else (
        shapes["loc_ell"][-2] if "loc_ell" in shapes else None)
    return (f"{model} {layout} W={window}, {shapes['node_feat'][0]} node rows, "
            f"{len(sig)} arrays")


class _Inputs:
    """A signature's static device inputs: one buffer laid out by
    ``input_layout`` and the batch views over it that a captured graph
    reads."""

    def __init__(self, sig: tuple, device: torch.device):
        _, total = input_layout(sig)
        self.static = torch.empty(total, dtype=torch.uint8, device=device)
        self.batch = input_views(self.static, sig)


class _Replay:
    """One captured forward: the graph, its output and the weight chunks
    it reads."""

    def __init__(self, graph, out: torch.Tensor, held: list):
        self.graph, self.out, self.held = graph, out, held


class InferenceStream:
    """Streaming runner for one model over (graph, weight set) pairs.

    ``param_sets`` are numpy weight dicts (``params.loaders``), each moved
    to ``device`` once as its own tensor set (``params_from_numpy``).
    ``run`` packs, runs and reads back one bucket after another;
    ``run_pipelined`` packs in worker threads while the card runs. Both
    replay the same captured graphs on the card."""

    def __init__(
        self,
        model: str,
        param_sets: Sequence[dict],
        prec: Precision = FLOAT32,
        node_capacity: int = 4096,
        edge_capacity: int = 12288,
        graph_capacity: int = 256,
        device="cuda",
    ):
        self.spec = registry.get(model)
        self.prec = prec
        self.caps = (node_capacity, edge_capacity, graph_capacity)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("InferenceStream: no CUDA device (device='cpu' runs the "
                                   "plain versions)")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = [params_from_numpy(p, prec, self.device) for p in param_sets]
        self._blocked = "local_slots" if model in ("pna", "gat", "dgn") else "local_ell"
        self._pins: dict[int, dict] = {}  # per-window slot layout pins
        self._pin_lock = threading.Lock()
        self._inputs: dict[tuple, _Inputs] = {}  # signature -> static inputs
        self._graphs: dict[tuple, _Replay] = {}  # (signature, set) -> captured graph
        self.last_dispatches = 0  # dispatches issued by the last run
        self.last_buckets: list[tuple] = []  # (signature, set) of its buckets, in order
        self.pack_seconds: list[float] = []  # host time of each bucket's pack, last run

    # -- host half ---------------------------------------------------------

    def _make_batch(self, bucket: list[Graph]) -> tuple[dict, int]:
        """Window-aligned pack and the kernel layout of one bucket (numpy).

        Slot layouts pin their content-derived statics (slot depth, prefix
        caps) to the stream's values so far, so that the buckets of a stream
        share one signature; a bucket that exceeds a pin re-derives it, and
        the pins merge monotonically, under ``_pin_lock``."""
        max_nodes = max(g.num_nodes for g in bucket)
        window, block = choose_geometry(self.spec.name, max_nodes)
        packed = self._pack(bucket, window)
        # The bench entry's policy: GIN, GIN-VN and GCN take the slot layout
        # where the bucket fits the window, ELL (with its spill tail) where not.
        blocked = self._blocked
        if blocked == "local_ell" and max_nodes <= window:
            blocked = "local_slots"
        kw = {}
        if blocked == "local_slots":
            with self._pin_lock:
                kw = dict(self._pins.get(window, {}))
        try:
            batch = as_batch(packed, blocked=blocked, window=window, block=block, **kw)
            if kw and batch["slot_spill_mask"].any():
                # An under-pinned slot depth sent deeper in-degrees to the
                # spill tail: re-derive, so the whole-model kernel runs.
                raise ValueError("pinned slots overflowed")
        except ValueError:  # pins below this bucket's needs
            kw = {}
            batch = as_batch(packed, blocked=blocked, window=window, block=block)
        if blocked == "local_slots" and not kw:
            self._merge_pins(window, batch)
        for key in INT8_KEYS:
            a = np.asarray(batch[key])
            if a.size and (a.min() < -128 or a.max() > 127):
                raise ValueError(f"{key}: values in [{a.min()}, {a.max()}] do not fit the int8 "
                                 f"transfer")
            batch[key] = a.astype(np.int8)
        return batch, len(bucket)

    def _pack(self, bucket: list[Graph], window: int):
        """The bucket packed window-aligned: by the native packer
        (``runtime.native.pack_bucket_native``; ctypes releases the GIL, so
        the workers pack in parallel), or by ``core.graphs.
        pack_graphs_aligned`` where the graphs carry eigenvectors or the
        virtual-node marker, which the native packer does not. Byte for byte
        the same buckets (``tests/test_torch_runtime.py``)."""
        if self.spec.needs_eigen or any(g.node_vn is not None for g in bucket):
            return pack_graphs_aligned(
                bucket, node_capacity=self.caps[0], edge_capacity=self.caps[1],
                graph_capacity=self.caps[2], window=window, with_eigen=self.spec.needs_eigen)
        packed, consumed = native.pack_bucket_native(bucket, *self.caps, window=window)
        if consumed < len(bucket):
            raise ValueError(f"bucket of {len(bucket)} graphs exceeds the capacities "
                             f"{self.caps}: {consumed} fit")
        return packed

    def _merge_pins(self, window: int, batch: dict) -> None:
        """Merge a re-derived slot layout's statics into the window's pins,
        each the maximum of the old and the new (read, merged and written
        under the lock: workers re-derive concurrently)."""
        slots = int(batch["slot_geom"].shape[-1])
        caps = None
        if "slot_pcap_0" in batch:
            caps = tuple(int(batch[f"slot_pcap_{k}"].shape[-2]) for k in range(slots))
        with self._pin_lock:
            old = self._pins.get(window, {})
            pins: dict = {"slots": max(slots, old.get("slots", 0))}
            if caps is not None:
                # Missing deeper slots contribute the 64-row floor.
                pins["prefix_caps"] = tuple(max(c) for c in itertools.zip_longest(
                    caps, old.get("prefix_caps", ()), fillvalue=64))
            self._pins[window] = pins

    def _stage(self, bucket: list[Graph]) -> tuple[tuple, object, int]:
        """One bucket's host work, run in a worker thread: (its signature,
        its inputs, its graph count). On the card the inputs are one pinned
        buffer (``pack_inputs``), on the CPU the numpy batch."""
        t0 = time.perf_counter()
        batch, n = self._make_batch(bucket)
        sig = batch_signature(batch)
        inputs = pack_inputs(batch, sig, pin=True) if self.device.type == "cuda" else batch
        self.pack_seconds.append(time.perf_counter() - t0)
        return sig, inputs, n

    def _bucketize(self, items: Iterable[tuple[Graph, int]]) -> Iterator[tuple[list[Graph], int]]:
        """Group the item stream into buckets: a bucket closes when full or
        when the weight set changes (the bucket-granularity version of the
        per-graph reload flag, GIN/src/GIN_compute.cc:49-63)."""
        node_cap, edge_cap, graph_cap = self.caps

        def align_step(off: int, n: int, window: int) -> int:
            # pack_graphs_aligned's first pass: a window-fitting graph that
            # would straddle a boundary advances to the next window first.
            if n <= window:
                room = window - (off % window)
                if n > room:
                    off += room
            return off + n

        bucket: list[Graph] = []
        cur_set = None
        edges = aligned = max_nodes = 0
        for g, set_id in items:
            g = registry.apply_transforms(self.spec, [g])[0]
            if set_id >= len(self.params) or set_id < 0:
                raise ValueError(f"unknown weight set {set_id}")
            new_max = max(max_nodes, g.num_nodes)
            window, _ = choose_geometry(self.spec.name, max(new_max, 1))
            if new_max > max_nodes and bucket:
                # The window may have grown: recompute the alignment.
                aligned = 0
                for gg in bucket:
                    aligned = align_step(aligned, gg.num_nodes, window)
            new_aligned = align_step(aligned, g.num_nodes, window)
            boundary = (cur_set is not None and set_id != cur_set) or (
                new_aligned > node_cap or edges + g.num_edges > edge_cap
                or len(bucket) >= graph_cap)
            if boundary and bucket:
                yield bucket, cur_set
                bucket, edges, aligned, max_nodes = [], 0, 0, 0
                window, _ = choose_geometry(self.spec.name, g.num_nodes)
                new_aligned = align_step(0, g.num_nodes, window)
            bucket.append(g)
            cur_set = set_id
            aligned = new_aligned
            max_nodes = max(max_nodes, g.num_nodes)
            edges += g.num_edges
        if bucket:
            yield bucket, cur_set

    # -- device half -------------------------------------------------------

    def _values(self, preds: torch.Tensor) -> np.ndarray:
        if preds.dtype == torch.bfloat16:
            preds = preds.float()
        return preds.numpy()

    def _replay(self, sig: tuple, set_id: int, inputs: _Inputs) -> _Replay:
        """The captured graph of (``sig``, ``set_id``), captured on first use
        from the bucket that ``inputs`` holds now: one eager pass, then the
        capture. Raises where the forward cannot be captured."""
        rec = self._graphs.get((sig, set_id))
        if rec is not None:
            return rec
        params = self.params[set_id]
        self.spec.forward(params, inputs.batch, self.prec)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        held: list = []
        try:
            with local_layer.hold_packs(held), torch.cuda.graph(
                    graph, capture_error_mode="relaxed"):
                out = self.spec.forward(params, inputs.batch, self.prec)
        except RuntimeError as exc:
            raise RuntimeError(f"{describe(self.spec.name, sig)}, weight set {set_id}: its "
                               f"forward cannot be captured in a CUDA graph: {exc}") from exc
        rec = self._graphs[(sig, set_id)] = _Replay(graph, out, held)
        return rec

    def _enqueue(self, sig: tuple, set_id: int, buf: torch.Tensor, n: int) -> torch.Tensor:
        """One bucket on the card, all on the compute stream: its pinned
        buffer into the static inputs, the replay, the predictions into
        pinned host memory. Returns the host tensor, valid once the compute
        stream passes this point."""
        inputs = self._inputs.get(sig)
        if inputs is None:
            inputs = self._inputs[sig] = _Inputs(sig, self.device)
        inputs.static.copy_(buf, non_blocking=True)
        rec = self._replay(sig, set_id, inputs)
        rec.graph.replay()
        host = torch.empty(n, dtype=rec.out.dtype, pin_memory=True)
        host.copy_(rec.out[:n, 0], non_blocking=True)
        return host

    def _dispatch(self, group: list, set_id: int):
        """One dispatch: the staged buckets of ``group`` (one signature, one
        weight set) back to back. On the card it returns (the event behind
        the last bucket, the host tensors, the staged buffers, which must
        live until then); on the CPU the predictions."""
        self.last_buckets += [(sig, set_id) for sig, _, _ in group]
        if self.device.type == "cpu":
            outs = []
            for sig, batch, n in group:
                out = self.spec.forward(self.params[set_id], to_device(batch, self.device),
                                        self.prec)
                outs.append(self._values(out[:n, 0]))
            return None, outs, None
        hosts = [self._enqueue(sig, set_id, buf, n) for sig, buf, n in group]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done, hosts, group

    def _collect(self, pending) -> Iterator[np.ndarray]:
        done, outs, _ = pending
        if done is not None:
            done.synchronize()
            outs = [self._values(h) for h in outs]
        for out in outs:
            yield from out

    def _reset(self) -> None:
        self.last_dispatches = 0
        self.last_buckets = []
        self.pack_seconds = []

    def run(self, items: Iterable[tuple[Graph, int]]) -> Iterator[np.ndarray]:
        """Yield per-graph predictions in submission order, sequentially:
        pack bucket i, run bucket i, read back, repeat."""
        self._reset()
        for bucket, set_id in self._bucketize(items):
            pending = self._dispatch([self._stage(bucket)], set_id)
            self.last_dispatches += 1
            yield from self._collect(pending)

    def run_pipelined(
        self,
        items: Iterable[tuple[Graph, int]],
        depth: int = 2,
        chain: int = 4,
        workers: int = 3,
    ) -> Iterator[np.ndarray]:
        """The sustained pipeline: ``workers`` threads pack buckets ahead
        while the card runs, up to ``chain`` consecutive buckets of one
        signature and weight set go out back to back behind one event (one
        dispatch), and ``depth`` dispatches stay in flight before the oldest
        is read back. Predictions still come back in submission order."""
        it = self._bucketize(items)
        self._reset()
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pack_q: collections.deque = collections.deque()

            def refill():
                # Keep enough packs queued that the workers never idle while
                # the main thread waits on the card.
                while len(pack_q) < max(chain, workers + 1):
                    try:
                        bucket, sid = next(it)
                    except StopIteration:
                        return
                    pack_q.append((ex.submit(self._stage, bucket), sid))

            refill()
            pend: collections.deque = collections.deque()

            def drain(limit):
                while len(pend) > limit:
                    yield from self._collect(pend.popleft())

            while pack_q:
                group: list = []
                gsid = gsig = None
                while pack_q and len(group) < chain:
                    fut, sid = pack_q[0]
                    if group and not fut.done():
                        # Never wait to grow a chain: dispatch what is
                        # ready (a pack-bound stream dispatches one bucket
                        # at a time instead of waiting on chain assembly).
                        break
                    staged = fut.result()
                    if group and (sid != gsid or staged[0] != gsig):
                        break  # a weight flip or a new signature
                    pack_q.popleft()
                    refill()
                    group.append(staged)
                    gsid, gsig = sid, staged[0]
                pend.append(self._dispatch(group, gsid))
                self.last_dispatches += 1
                yield from drain(depth)
            yield from drain(0)

    def captured(self) -> list[tuple]:
        """The (signature, weight set) of every captured graph."""
        return list(self._graphs)

    def replay_ms(self, sig: tuple, set_id: int, reps: int = 20) -> float:
        """Device milliseconds of one replay of the captured graph of
        (``sig``, ``set_id``): CUDA events around ``reps`` replays
        (``bench.timing.cuda_ms``)."""
        from ..bench.timing import cuda_ms

        return cuda_ms(self._graphs[(sig, set_id)].graph.replay, reps)
