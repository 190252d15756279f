"""Paired host-path comparisons of the sustained stream: which bucket
packer, which ELL lane builder, which host-to-device path and how many pack
workers ``runtime.stream`` should take.

    python -m flowgnn_tpu_torch.bench.host_ab --model gin --pairs 10
    python -m flowgnn_tpu_torch.bench.host_ab --device cpu --graphs 32 --pairs 2   # tests only

Over the stream ``bench.host_app`` builds (``--graphs`` molhiv-shaped graphs,
two weight sets flipped at half the stream, caps 32768 / 2048, bf16), each
comparison takes ``--pairs`` pairs of samples, the two sides of a pair in
alternating order (A then B, then B then A):

- ``pack``: host ms of a bucket's window-aligned pack, mean over the
  stream's buckets: the numpy packer (``core.graphs.pack_graphs_aligned``)
  against the native one (``runtime.native.pack_bucket_native``, the
  stream's). Not for DGN and GIN-VN, whose eigenvectors and virtual-node
  marker the native packer does not carry, so the stream packs them in numpy;
- ``ell``: host ms of a bucket's ELL lanes at the bucket's window, mean over
  the buckets: the numpy loop (``core.blocking._local_ell_lanes``) against
  ``build_local_ell_native`` (``core.blocking.build_local_blocks_ell``'s);
- ``stream_pack``: the pipelined stream's µs/graph (``run_pipelined``,
  depth 2, chain 4, three workers; wall time of the whole run) with either
  packer;
- ``h2d`` (on the card): the same with the stream's host-to-device path
  (the pinned buffer straight into the static inputs on the compute stream)
  against a copy stream into a staging buffer, the compute stream waiting on
  the copy's event and copying the staging buffer into the static inputs;
- ``workers``: the same with three pack workers against ``--workers-b``.

Every stream is warmed up as ``bench.host_app`` warms it (a pin pass, then
one sequential run that captures every graph), and that run's predictions
must equal the stream's, bit for bit. stdout: one JSON line per
comparison with every sample unrounded, each side's median and the pairs
each side won; the card's name and power limit first, on a ``#`` line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..core.blocking import _local_ell_lanes
from ..core.graphs import laplacian_eigenvectors, pack_graphs_aligned
from ..core.numerics import BF16
from ..core.synthetic import synthetic_molhiv
from ..models import registry
from ..models.base import choose_geometry
from ..runtime import native
from ..runtime.stream import InferenceStream, _Inputs
from . import host_app
from .matmul_shapes import tool_device


class NumpyPackStream(InferenceStream):
    """The stream with the numpy bucket packer."""

    def _pack(self, bucket, window):
        return pack_graphs_aligned(
            bucket, node_capacity=self.caps[0], edge_capacity=self.caps[1],
            graph_capacity=self.caps[2], window=window, with_eigen=self.spec.needs_eigen)


class CopyStreamStream(InferenceStream):
    """The stream with a copy stream: each bucket's pinned buffer goes to a
    per-signature staging buffer on a second stream; the compute stream
    waits on that copy's event, copies the staging buffer into the static
    inputs and records the event that frees the staging buffer."""

    def _enqueue(self, sig, set_id, buf, n):
        if not hasattr(self, "_copy"):
            self._copy, self._staging = torch.cuda.Stream(self.device), {}
        inputs = self._inputs.get(sig)
        if inputs is None:
            inputs = self._inputs[sig] = _Inputs(sig, self.device)
            self._staging[sig] = (torch.empty_like(inputs.static), torch.cuda.Event())
        staging, free = self._staging[sig]
        compute = torch.cuda.current_stream(self.device)
        self._copy.wait_event(free)
        with torch.cuda.stream(self._copy):
            staging.copy_(buf, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy)
        compute.wait_event(ready)
        inputs.static.copy_(staging)
        free.record(compute)
        rec = self._replay(sig, set_id, inputs)
        rec.graph.replay()
        host = torch.empty(n, dtype=rec.out.dtype, pin_memory=True)
        host.copy_(rec.out[:n, 0], non_blocking=True)
        return host


def paired(pairs: int, a, b) -> tuple[list, list]:
    """``pairs`` samples of ``a()`` and ``b()``, A first in even pairs and
    B first in odd ones."""
    xs, ys = [], []
    for i in range(pairs):
        if i % 2 == 0:
            xs.append(a())
            ys.append(b())
        else:
            ys.append(b())
            xs.append(a())
    return xs, ys


def record(name: str, unit: str, a_name: str, b_name: str, xs: list, ys: list) -> dict:
    a_wins = sum(x < y for x, y in zip(xs, ys))
    return {"comparison": name, "unit": unit, a_name: xs, b_name: ys,
            f"median_{a_name}": statistics.median(xs), f"median_{b_name}": statistics.median(ys),
            f"{a_name}_wins": a_wins, f"{b_name}_wins": len(xs) - a_wins}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gin", choices=list(host_app.U50_US))
    ap.add_argument("--graphs", type=int, default=16384)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--workers-b", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    native.load_library()  # built before any sample
    app = host_app.parse_args(["--model", args.model, "--graphs", str(args.graphs),
                               "--flip", str(max(args.graphs // 2, 1))])
    spec = registry.get(args.model)
    graphs = synthetic_molhiv(args.graphs, seed=0)
    if spec.needs_eigen:
        graphs = [laplacian_eigenvectors(g) for g in graphs]
    items = [(g, (i // app.flip) % app.sets) for i, g in enumerate(graphs)]
    sets = host_app.weight_sets(app)
    caps = dict(node_capacity=app.node_cap, graph_capacity=app.graph_cap,
                edge_capacity=host_app.edge_capacity(graphs, app.node_cap))

    served = []

    def stream(cls):
        """A warmed-up stream of ``cls``, which must serve what the first
        one served."""
        s = cls(args.model, sets, BF16, device=device, **caps)
        for bucket, _ in s._bucketize(items):  # host_app's warm-up
            s._make_batch(bucket)
        served.append(np.array(list(s.run(items))))
        np.testing.assert_array_equal(served[-1], served[0], err_msg=cls.__name__)
        return s

    def per_graph_us(s, workers=app.workers):
        def run():
            t0 = time.perf_counter()
            n = len(list(s.run_pipelined(items, depth=app.depth, chain=app.chain,
                                         workers=workers)))
            return (time.perf_counter() - t0) / n * 1e6
        return run

    base = stream(InferenceStream)
    buckets = [(b, choose_geometry(args.model, max(g.num_nodes for g in b)))
               for b, _ in base._bucketize(items)]

    def mean_ms(fn):
        def run():
            total = 0.0
            for bucket, geom in buckets:
                t0 = time.perf_counter()
                fn(bucket, geom)
                total += time.perf_counter() - t0
            return total / len(buckets) * 1e3
        return run

    out = []
    carries = not spec.needs_eigen and all(g.node_vn is None for b, _ in buckets for g in b)
    if carries:
        out.append(record("pack", "ms/bucket", "numpy", "native", *paired(
            args.pairs, mean_ms(lambda b, geom: NumpyPackStream._pack(base, b, geom[0])),
            mean_ms(lambda b, geom: base._pack(b, geom[0])))))
    packed = [base._pack(b, geom[0]) for b, geom in buckets]

    def ell(fn):
        def run():
            total = 0.0
            for p, (_, (window, block)) in zip(packed, buckets):
                n = p.node_capacity + 1
                t0 = time.perf_counter()
                fn(p.senders, p.receivers, n, window, block, None)
                total += time.perf_counter() - t0
            return total / len(packed) * 1e3
        return run

    out.append(record("ell", "ms/bucket", "numpy", "native", *paired(
        args.pairs, ell(_local_ell_lanes), ell(native.build_local_ell_native))))
    if carries:
        out.append(record("stream_pack", "us/graph", "numpy", "native", *paired(
            args.pairs, per_graph_us(stream(NumpyPackStream)), per_graph_us(base))))
    if device.type == "cuda":
        out.append(record("h2d", "us/graph", "direct", "copy_stream", *paired(
            args.pairs, per_graph_us(base), per_graph_us(stream(CopyStreamStream)))))
    out.append(record("workers", "us/graph", f"workers_{app.workers}",
                      f"workers_{args.workers_b}", *paired(
                          args.pairs, per_graph_us(base),
                          per_graph_us(base, args.workers_b))))
    for rec in out:
        print(json.dumps({"model": args.model, "graphs": args.graphs, "device": device.type,
                          **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
