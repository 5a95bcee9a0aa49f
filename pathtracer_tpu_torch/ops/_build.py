"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``pathtracer_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/torch_kernels/lib<name>-<hash>.so`` at first use and loaded with
``ctypes``; the hash covers the source, every header of ``csrc/`` (the
sources share ``trace_common.cuh``) and the flags, so a library built by an
earlier process of the same checkout is reused and an edited header
rebuilds every kernel.  The sources expose
plain C entry points (no PyTorch headers), so a build takes seconds.
Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` without fast
math, so that the kernels round as the op-by-op plain versions do.  A
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict = {}  # name -> loaded library, one per process
build_seconds: dict = {}  # name -> wall seconds of its last compile in this process


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def kernel_names() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the headers of ``csrc/`` and the flags."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith((".cuh", ".h")))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def compile_kernel(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless an identical build exists;
    returns ``(library path, ptxas report or "" when reused)``."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = source_digest(name)
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a process that loaded `out` keeps its copy
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return out, proc.stderr


def build_all() -> dict:
    """Compile every kernel source, one ``nvcc`` per source, all started
    together, and load them; returns ``{name: ptxas report}``."""
    names = kernel_names()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = list(pool.map(compile_kernel, names))
    reports = {}
    for name, (path, report) in zip(names, results):
        _LIBS[name] = ctypes.CDLL(path)
        reports[name] = report
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(compile_kernel(name)[0])
    return _LIBS[name]
