"""Build the port's CUDA sources into ctypes libraries on first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for sm_90a into ``flowgnn_tpu_torch/_build/<name>-<hash>.so``, keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds. The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<name>-<hash>.log``. A failed build raises.
``build_libraries`` compiles several sources in parallel. Nothing is built
when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the default toolkit prefix, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_libraries(names) -> list[Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is not
    built yet, one ``nvcc`` per source, all started together; returns the
    libraries' paths in the order of ``names``. Raises if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        try:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{log}")
            else:
                os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(name) for name in names]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build_libraries([name])[0]))
