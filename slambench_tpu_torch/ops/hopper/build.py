"""Build and load the hand-written Hopper kernels.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface under ``_build/`` (listed in
``.gitignore``), or under ``$SLAMBENCH_JIT_CACHE/hopper`` when that
variable names a directory, named by a hash of the sources and flags;
the library is loaded with ``ctypes``. A plain C interface keeps PyTorch's
headers out of the build, so it takes seconds rather than minutes.

There is no fallback: a missing ``nvcc`` or a failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CACHE_ENV = "SLAMBENCH_JIT_CACHE"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# What the last build printed (ptxas register / spill report) and took.
build_log = ""
build_seconds = 0.0


def build_dir(sub: str = "hopper", default: Optional[str] = None) -> str:
    """The directory a library builds in: ``$SLAMBENCH_JIT_CACHE/<sub>``
    when the variable names one; unset, ``0`` or ``off``: ``default``
    (by default ``BUILD_DIR``, the ignored ``_build/``)."""
    path = os.environ.get(CACHE_ENV, "")
    if path and path.lower() not in ("0", "off"):
        return os.path.join(path, sub)
    return BUILD_DIR if default is None else default


def find_nvcc() -> str:
    """Path of ``nvcc``: $PATH first, then $CUDA_HOME and /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (searched $PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the Hopper kernels are compiled from slambench_tpu_torch/ops/hopper/"
        "csrc at first use and there is no prebuilt or fallback path")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slb_bilateral_f32.argtypes = [vp, vp, ci, ci, vp, cf, vp]
    lib.slb_bilateral_f32.restype = ci
    lib.slb_mm2m_bilateral_f32.argtypes = [vp, vp, vp, ci, ci, ci, vp, cf,
                                           vp, vp, vp]
    lib.slb_mm2m_bilateral_f32.restype = ci
    lib.slb_reduce_track_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                         ci, vp]
    lib.slb_reduce_track_f32.restype = ci
    lib.slb_track_reduce_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                         vp, ci, ci, ci, cf, cf, ci, ci, ci,
                                         vp, vp, vp]
    lib.slb_track_reduce_f32.restype = ci
    return bind_gather(lib)


def bind_gather(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Bind the entry points of ``csrc/gather.cu`` (G1-G4)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.slb_gather_flat.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, vp]
    lib.slb_gather_axis_smem_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                             ci, vp]
    lib.slb_gather_smem_u16.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.slb_gather_2d_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      vp]
    for fn in (lib.slb_gather_flat, lib.slb_gather_axis_smem_f32,
               lib.slb_gather_smem_u16, lib.slb_gather_2d_f32):
        fn.restype = ci
    return lib


def build() -> str:
    """Compile the sources if no library of this hash exists; returns
    the library path."""
    global build_log, build_seconds
    digest = _digest()
    bdir = build_dir()
    out = os.path.join(bdir, f"libslb_hopper_{digest}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(bdir, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    t0 = time.monotonic()
    jobs = []
    for src in _sources():
        obj = os.path.join(bdir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], None
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    tmp = f"{out}.{os.getpid()}.tmp"
    if failed is None:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode)
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.monotonic() - t0
    build_log = "".join(logs)
    if failed is not None:
        raise RuntimeError(f"nvcc failed (exit {failed[1]}): "
                           f"{' '.join(failed[0])}\n{build_log}")
    os.replace(tmp, out)
    return out


def build_variants(sources: dict, prefix: str) -> dict:
    """Compile each ``{name: CUDA source}`` into a shared library of its
    own under ``build_dir()`` (one ``nvcc`` process each, all started
    together), for the tools that time copies of a kernel changed in one
    place; returns ``{name: CDLL}``, unbound."""
    bdir = build_dir()
    os.makedirs(bdir, exist_ok=True)
    nvcc, jobs = find_nvcc(), {}
    for name, src in sources.items():
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu = os.path.join(bdir, f"{prefix}_{digest}.cu")
        path = os.path.join(bdir, f"lib{prefix}_{digest}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", path, cu]
        jobs[name] = (cmd, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cmd, path, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        libs[name] = ctypes.CDLL(path)
    return libs


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()))
    return _lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
