"""ctypes bindings to the native IO library ``libslamio`` (port of
``slambench_tpu/io/native.py``).

``slambench_tpu_torch/native/slamio.cpp`` is a byte-for-byte copy of the
JAX package's ``slambench_tpu/native/slamio.cpp``: a memory-mapped RAW
container reader with next-frame prefetch, a fast ASCII ``.depth``
parser, the euclidean->planar converter and the RAW frame writer
(reference: kfusion/include/interface.h, thirdparty/scene2raw.cpp).

At first use the port builds its own copy with ``g++ -O3 -fPIC -shared
-std=c++17`` into ``native/_build/`` (listed in ``.gitignore``), or into
``$SLAMBENCH_JIT_CACHE/native`` when that variable names a directory
(``ops/hopper/build.py:build_dir``), named by a hash of the source and
flags, and loads it with ``ctypes``; it never
loads the JAX package's ``libslamio.so``. A missing compiler or a failed
build raises with the compiler's output: there is no quiet fallback to
the numpy readers (``SLAMBENCH_NATIVE_IO=0`` selects those, in
``io/readers.py:make_reader``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from slambench_tpu_torch.ops.hopper.build import build_dir

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
SOURCE = os.path.join(_NATIVE, "slamio.cpp")
BUILD_DIR = os.path.join(_NATIVE, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def find_cxx() -> str:
    """The C++ compiler: ``$CXX`` if set, else ``g++`` on ``$PATH``."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the native IO library is "
            f"built from {SOURCE} at first use (set SLAMBENCH_NATIVE_IO=0 "
            "for the numpy readers)")
    return found


def build() -> str:
    """Compile ``SOURCE`` unless a library of its hash exists in the
    build directory (``BUILD_DIR`` unless ``SLAMBENCH_JIT_CACHE`` names
    one); returns the library path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            " ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    bdir = build_dir("native", BUILD_DIR)
    out = os.path.join(bdir, f"libslamio_{digest}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE]
    os.makedirs(bdir, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native IO build failed (exit {proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, u32, u64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    lib.slamio_open_raw.restype = vp
    lib.slamio_open_raw.argtypes = [ctypes.c_char_p]
    lib.slamio_close.argtypes = [vp]
    lib.slamio_raw_info.argtypes = [
        vp, ctypes.POINTER(u32), ctypes.POINTER(u32), ctypes.POINTER(u64)]
    lib.slamio_depth_ptr.restype = ctypes.POINTER(ctypes.c_uint16)
    lib.slamio_depth_ptr.argtypes = [vp, u64]
    lib.slamio_rgb_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.slamio_rgb_ptr.argtypes = [vp, u64]
    lib.slamio_read_depth.argtypes = [vp, u64,
                                      ctypes.POINTER(ctypes.c_uint16)]
    lib.slamio_write_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u32, u32,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8)]
    lib.slamio_parse_depth_ascii.restype = ctypes.c_int64
    lib.slamio_parse_depth_ascii.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.slamio_planarize_mm.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()))
    return _lib


class NativeRawReader:
    """Zero-copy mmap'd RAW reader with OS prefetch; the surface of
    ``io/readers.py:RawDepthReader`` without the fps pacing."""

    def __init__(self, filename: str):
        lib = load()
        self._lib = lib
        self._h = lib.slamio_open_raw(filename.encode())
        if not self._h:
            raise IOError(f"cannot open RAW file {filename}")
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        n = ctypes.c_uint64()
        lib.slamio_raw_info(self._h, ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(n))
        self._size = (w.value, h.value)
        self.n_frames = n.value
        self._frame = -1
        self.camera_open = True

    def get_input_size(self) -> Tuple[int, int]:
        return self._size

    def get_k(self):
        # Reference default for RAW without -k (interface.h:314-316).
        return (531.15, 531.15, 640 / 2, 480 / 2)

    def read_next_depth_frame(self) -> Optional[np.ndarray]:
        self._frame += 1
        return self.read_depth(self._frame)

    def read_depth(self, frame: int) -> Optional[np.ndarray]:
        """uint16 [h, w] view into the mapping (valid until close), or
        None past the last frame."""
        if frame < 0:
            return None
        p = self._lib.slamio_depth_ptr(self._h, frame)
        if not p:
            return None
        w, h = self._size
        return np.ctypeslib.as_array(p, shape=(h, w))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.slamio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def parse_depth_ascii(path: str, n: int) -> np.ndarray:
    """The first ``n`` floats of an ASCII ``.depth`` file as float32
    [n]; raises if the file holds fewer."""
    out = np.empty(n, np.float32)
    got = load().slamio_parse_depth_ascii(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got < n:
        raise ValueError(f"{path}: parsed {got} of {n} depth values")
    return out


def planarize_mm(euclid: np.ndarray, fx: float, fy: float,
                 cx: float, cy: float) -> np.ndarray:
    """Euclidean ray lengths (m) -> planar millimetre uint16 [h, w]."""
    h, w = euclid.shape
    euclid = np.ascontiguousarray(euclid, np.float32)
    out = np.empty((h, w), np.uint16)
    load().slamio_planarize_mm(
        euclid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        w, h, fx, fy, cx, cy)
    return out


def write_frame(path: str, append: bool, depth_mm: np.ndarray,
                rgb: Optional[np.ndarray] = None) -> None:
    """Write (or append) one RAW frame record; raises on failure."""
    h, w = depth_mm.shape
    depth_mm = np.ascontiguousarray(depth_mm, np.uint16)
    rgb_ptr = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        rgb_ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = load().slamio_write_frame(
        path.encode(), 1 if append else 0, w, h,
        depth_mm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), rgb_ptr)
    if rc != 0:
        raise OSError(f"slamio_write_frame({path}) failed with {rc}")
