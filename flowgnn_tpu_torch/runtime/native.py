"""ctypes bindings for the native host packer (``runtime/packer.cc``).

The counterpart of ``flowgnn_tpu/runtime/native.py``. The shared library is
built on first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``flowgnn_tpu_torch/_build/fgpacker-<hash>.so``, keyed by a hash of the
source and the flags as ``ops/build.py`` keys the CUDA libraries, so an
edited source rebuilds and nothing is written beside the source. Where the
JAX package falls back to numpy whenever the build or the load fails, here a
failure raises. ``core.blocking.build_local_blocks_ell`` takes its lanes from
``build_local_ell_native``; the numpy loop there is its oracle.
``tests/test_torch_runtime.py`` holds every binding byte-equal to the port's
numpy code and to the JAX package's. Node ids outside their graph raise
``ValueError`` before they reach the library.

ctypes releases the GIL for the length of each call, so the stream's worker
threads pack buckets in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.features import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from ..core.graphs import Graph, PackedGraphs
from ..ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "packer.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_i32p = ctypes.POINTER(ctypes.c_int32)
_I32 = ctypes.c_int32


def library_path() -> Path:
    """Where ``packer.cc`` builds to under the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + "\0".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"fgpacker-{digest[:16]}.so"


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native packer cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native packer, once per process;
    raises where it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        pack_args = [_i32p, _i32p, _i32p, _i32p, _i32p, _I32, _I32, _I32, _I32]
        outs = [_i32p] * 7
        lib.fg_pack_bucket.argtypes = pack_args + outs
        lib.fg_pack_bucket.restype = _I32
        lib.fg_pack_bucket_aligned.argtypes = pack_args + [_I32] + outs
        lib.fg_pack_bucket_aligned.restype = _I32
        lib.fg_add_virtual_node.argtypes = [_i32p, _i32p, _i32p, _I32, _I32, _i32p, _i32p, _i32p]
        lib.fg_add_virtual_node.restype = None
        lib.fg_add_self_loops.argtypes = [_i32p, _I32, _I32, _i32p]
        lib.fg_add_self_loops.restype = None
        lib.fg_build_local_ell.argtypes = [
            _i32p, _i32p, ctypes.c_int64, _I32, _I32, _I32, _i32p, _i32p, _i32p, _i32p, _i32p,
            _i32p,
        ]
        lib.fg_build_local_ell.restype = _I32
        lib.fg_read_graph.argtypes = [ctypes.c_char_p, _I32, _i32p, _i32p, _i32p, _i32p]
        lib.fg_read_graph.restype = _I32
        _lib = lib
        return _lib


def _ptr(arr: Optional[np.ndarray]):
    if arr is None:
        return None
    if arr.dtype != np.int32 or not arr.flags["C_CONTIGUOUS"]:
        raise TypeError(f"native packer: want a C-contiguous int32 array, got {arr.dtype}")
    return arr.ctypes.data_as(_i32p)


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, np.int32)


def pack_bucket_native(
    graphs: list[Graph], node_capacity: int, edge_capacity: int, graph_capacity: int,
    window: int = 0,
) -> tuple[PackedGraphs, int]:
    """Pack as many of ``graphs`` as fit; returns (bucket, graphs consumed).
    ``window`` > 0 packs window-aligned (``fg_pack_bucket_aligned``), byte
    for byte ``core.graphs.pack_graphs_aligned`` for graphs without
    eigenvector or virtual-node payloads; 0 packs as ``pack_graphs``."""
    lib = load_library()
    node_feat = _i32(np.concatenate([g.node_feat for g in graphs]))
    edge_index = _i32(np.concatenate([g.edge_index for g in graphs]))
    edge_attr = None
    if graphs[0].edge_attr is not None:
        edge_attr = _i32(np.concatenate([g.edge_attr for g in graphs]))
    n_nodes = np.array([g.num_nodes for g in graphs], np.int32)
    n_edges = np.array([g.num_edges for g in graphs], np.int32)
    if edge_index.size and (edge_index.min() < 0 or (
            edge_index >= np.repeat(n_nodes, n_edges)[:, None]).any()):
        raise ValueError("pack_bucket_native: an edge names a node outside its graph")

    out = (
        np.empty((node_capacity + 1, NUM_ATOM_FEATURES), np.int32),
        np.empty(node_capacity + 1, np.int32),
        np.empty(edge_capacity, np.int32),
        np.empty(edge_capacity, np.int32),
        np.empty((edge_capacity, NUM_BOND_FEATURES), np.int32),
        np.empty(graph_capacity + 1, np.int32),
        np.empty(graph_capacity + 1, np.int32),
    )
    ins = (_ptr(node_feat), _ptr(edge_index), _ptr(edge_attr), _ptr(n_nodes), _ptr(n_edges),
           len(graphs), node_capacity, edge_capacity, graph_capacity)
    if window > 0:
        consumed = lib.fg_pack_bucket_aligned(*ins, window, *map(_ptr, out))
    else:
        consumed = lib.fg_pack_bucket(*ins, *map(_ptr, out))
    if consumed < 0:
        raise ValueError("first graph exceeds bucket capacity")
    return PackedGraphs(*out, None), int(consumed)


def pack_dataset_native(graphs: list[Graph], node_capacity: int, edge_capacity: int,
                        graph_capacity: int):
    """Greedy streaming packer over the native bucket packer (unaligned)."""
    i = 0
    while i < len(graphs):
        bucket, consumed = pack_bucket_native(graphs[i:], node_capacity, edge_capacity,
                                              graph_capacity)
        yield bucket
        i += consumed


def read_graph_native(dataset_dir: str, index: int, with_attr: bool = True) -> Graph:
    """Graph ``index`` (1-based) of a reference-layout dataset directory, as
    ``core.io.read_graph`` reads it (``fg_read_graph``)."""
    lib = load_library()
    counts = np.zeros(2, np.int32)
    path = os.fsencode(dataset_dir)
    rc = lib.fg_read_graph(path, index, _ptr(counts), None, None, None)
    if rc != 0:
        raise FileNotFoundError(f"graph {index} in {dataset_dir}: rc={rc}")
    n, e = int(counts[0]), int(counts[1])
    node_feat = np.empty((n, NUM_ATOM_FEATURES), np.int32)
    edge_index = np.empty((e, 2), np.int32)
    edge_attr = np.empty((e, NUM_BOND_FEATURES), np.int32) if with_attr else None
    rc = lib.fg_read_graph(path, index, _ptr(counts), _ptr(node_feat), _ptr(edge_index),
                           _ptr(edge_attr))
    if rc != 0:
        raise IOError(f"graph {index} in {dataset_dir}: read failed, rc={rc}")
    return Graph(node_feat, edge_index, edge_attr)


def build_local_ell_native(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                           window: int, block: int, k_blocks: Optional[int] = None):
    """The graph-local ELL layout (``fg_build_local_ell``), lane for lane
    ``core.blocking.build_local_blocks_ell``'s numpy loop: returns
    (u_local, v_local, edge_perm, valid, spill indices, k_blocks)."""
    lib = load_library()
    s, r = _i32(senders), _i32(receivers)
    e = s.shape[0]
    if e and (min(s.min(), r.min()) < 0 or max(s.max(), r.max()) >= num_nodes):
        raise ValueError(f"build_local_ell_native: node ids outside [0, {num_nodes})")
    k_io = _I32(-1 if k_blocks is None else k_blocks)
    if k_blocks is None:  # probe: k from the window counts
        if lib.fg_build_local_ell(_ptr(s), _ptr(r), e, num_nodes, window, block,
                                  ctypes.byref(k_io), None, None, None, None, None) < 0:
            raise ValueError(f"build_local_ell_native: node ids outside [0, {num_nodes})")
    p = -(-num_nodes // window) * k_io.value * block
    u_local, v_local, edge_perm, valid = (np.empty(p, np.int32) for _ in range(4))
    spill = np.empty(max(e, 1), np.int32)
    n_spill = lib.fg_build_local_ell(
        _ptr(s), _ptr(r), e, num_nodes, window, block, ctypes.byref(k_io), _ptr(u_local),
        _ptr(v_local), _ptr(edge_perm), _ptr(valid), _ptr(spill))
    if n_spill < 0:
        raise ValueError(f"build_local_ell_native: node ids outside [0, {num_nodes})")
    return (u_local, v_local, edge_perm, valid.astype(bool), spill[:n_spill].copy(),
            int(k_io.value))


def add_self_loops_native(g: Graph) -> Graph:
    """``core.graphs.add_self_loops`` through ``fg_add_self_loops``: one self
    edge per node first, with zero bond attributes."""
    lib = load_library()
    n, e = g.num_nodes, g.num_edges
    edge_index = np.empty((n + e, 2), np.int32)
    lib.fg_add_self_loops(_ptr(_i32(g.edge_index)), n, e, _ptr(edge_index))
    edge_attr = None
    if g.edge_attr is not None:
        edge_attr = np.concatenate([np.zeros((n, NUM_BOND_FEATURES), np.int32),
                                    _i32(g.edge_attr)])
    return Graph(g.node_feat, edge_index, edge_attr, g.node_eigen, g.node_vn)


def add_virtual_node_native(g: Graph) -> Graph:
    """The materialized virtual node (``fg_add_virtual_node``, the JAX
    package's ``core.graphs.add_virtual_node``): one zero-feature node and
    the bidirectional star of 2N zero-attribute edges appended."""
    lib = load_library()
    n, e = g.num_nodes, g.num_edges
    node_feat = np.empty((n + 1, NUM_ATOM_FEATURES), np.int32)
    edge_index = np.empty((e + 2 * n, 2), np.int32)
    edge_attr = None if g.edge_attr is None else np.empty((e + 2 * n, NUM_BOND_FEATURES),
                                                          np.int32)
    lib.fg_add_virtual_node(
        _ptr(_i32(g.node_feat)), _ptr(_i32(g.edge_index)),
        None if g.edge_attr is None else _ptr(_i32(g.edge_attr)), n, e, _ptr(node_feat),
        _ptr(edge_index), _ptr(edge_attr))
    return Graph(node_feat, edge_index, edge_attr)
