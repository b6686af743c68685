"""Build the port's CUDA C++ sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Outputs go to ``espresso_tpu_torch/csrc/build/<hash>/`` (listed in
``.gitignore``), keyed on a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads the cached library. Nothing is
built when a module is imported: only the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Sequence, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, sources: Sequence[str]) -> Tuple[str, str]:
    """(directory, .so path) for a library built from ``sources``
    (file names under csrc/, the headers they include among them), keyed
    on their bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    return out_dir, os.path.join(out_dir, f"lib{name}.so")


def build(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` into ``lib<name>.so`` unless the hashed build
    exists; returns the library path. ``nvcc``'s output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it in
    ``<name>.log``."""
    out_dir, so_path = library_path(name, sources)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    # compile to a temporary name and rename: a process building at the same
    # time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp]
    # headers (.cuh) are hashed with the sources but only included by them
    cmd += [os.path.join(CSRC_DIR, s) for s in sources if s.endswith(".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, so_path)
    return so_path


def build_many(libraries: Iterable[Tuple[str, Sequence[str]]]) -> List[str]:
    """Build several libraries at once, one ``nvcc`` process each, all
    started together; returns their paths. Raises the first build error."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = [pool.submit(build, name, sources) for name, sources in libraries]
        return [f.result() for f in futures]


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``."""
    return ctypes.CDLL(build(name, sources))


def build_log(name: str, sources: Sequence[str]) -> str:
    out_dir, _ = library_path(name, sources)
    path = os.path.join(out_dir, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
