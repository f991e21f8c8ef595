"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for
Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>.<digest>.so``
at the root of the checkout, on first use. The digest is of the source,
the headers it includes from ``csrc/`` and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module on
a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building in this process, ptxas report)
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: Dict[str, bytes]) -> None:
    """``path`` and, recursively, every file it includes with quotes,
    resolved beside the including file (as nvcc resolves them)."""
    path = os.path.realpath(path)
    if path in seen:
        return
    with open(path, "rb") as f:
        seen[path] = f.read()
    for inc in _INCLUDE.findall(seen[path]):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if os.path.exists(dep):
            _sources(dep, seen)


def lib_path(name: str, src_dir: str = SRC_DIR) -> str:
    """Where ``<src_dir>/<name>.cu`` is built: the name carries a digest
    of the source, of every header it includes from the checkout, and of
    the flags, so an edit to any of them builds a new library."""
    seen: Dict[str, bytes] = {}
    _sources(os.path.join(src_dir, f"{name}.cu"), seen)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(seen):
        digest.update(os.path.relpath(path, src_dir).encode() + b"\0")
        digest.update(seen[path])
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    # Atomic: a concurrent process building the same digest is harmless.
    os.replace(tmp, out)
    report = "\n".join(
        ln for ln in (proc.stdout + proc.stderr).splitlines()
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln
        or "warning" in ln)  # ptxas's C7518 (serialised wgmma) among them
    with open(out + ".ptxas.txt", "w") as f:
        f.write(report + "\n")
    build_info[name] = (time.perf_counter() - t0, report)


def build_all(names) -> None:
    """Build every library of ``names`` that is not built yet, one nvcc
    for each, all started together."""
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    with _lock, ThreadPoolExecutor(max(len(todo), 1)) as pool:
        for f in [pool.submit(_compile, n, lib_path(n)) for n in todo]:
            f.result()


def build_variants(name: str, out_dir: str, variants) -> Dict[str, ctypes.CDLL]:
    """variant -> the library of ``csrc/<name>.cu`` with that variant's
    (text, replacement) made in a copy under ``out_dir`` (the text must
    appear in the source once; the copy includes the headers of
    ``csrc/``), one nvcc each, all started together: the probes' build
    variants, loaded without argtypes."""
    with open(os.path.join(SRC_DIR, f"{name}.cu")) as f:
        src = f.read()

    def build(variant):
        old, new = variants[variant][:2]
        if src.count(old) != 1:
            raise RuntimeError(f"variant {variant!r}: its text is not in the "
                               "source once")
        d = os.path.join(out_dir, "".join(c if c.isalnum() else "_"
                                          for c in variant))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        lib = os.path.join(d, f"lib{name}.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-o", lib,
                               path], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {variant!r}: nvcc failed\n"
                               f"{proc.stderr}")
        return lib

    with ThreadPoolExecutor(max(len(variants), 1)) as pool:
        paths = dict(zip(variants, pool.map(build, variants)))
    return {v: ctypes.CDLL(p) for v, p in paths.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = lib_path(name)
            if not os.path.exists(out):
                _compile(name, out)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib
