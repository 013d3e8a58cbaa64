"""Depth-stream readers with the reference's real-time pacing semantics.

A copy of ``slambench_tpu/io/readers.py`` (the JAX package cannot be
imported without JAX): ``DepthReader``, ``RawDepthReader``, the ICL-NUIM
``SceneDepthReader``, the native-backed ``NativeBackedRawReader``, the
``.scf`` scene-config parser and ``make_reader``. A ``.raw`` file gets
the native reader (``io/native.py``, built at first use; a failed build
raises); ``SLAMBENCH_NATIVE_IO=0`` (or ``off``) selects the numpy
``RawDepthReader``.
(reference: kfusion/include/interface.h:28-318, kfusion/src/reader.cpp)
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Optional

import numpy as np

from slambench_tpu_torch.config import parse_float4
from slambench_tpu_torch.io.raw import frame_nbytes, read_raw_header

# ICL-NUIM scene camera (reference: interface.h:89-97). The negative fy
# is the planarization's; the reader reports the positive one.
SCENE_K = (481.20, -480.00, 319.50, 239.50)
SCENE_SIZE = (640, 480)


class DepthReader:
    """Base reader: frame counting + fps pacing (reference:
    interface.h:28-87)."""

    def __init__(self, fps: int = 0, blocking_read: bool = False):
        self._frame = -1
        self._fps = fps
        self._blocking_read = blocking_read
        self._first_time: Optional[float] = None
        self.camera_open = False

    def restart(self) -> None:
        """Back to before the first frame (the dashboard's restart)."""
        self._frame = -1
        self._first_time = None

    def get_next_frame(self) -> None:
        """Advance the frame cursor; in fps mode the index follows the
        wall clock, so a slow consumer drops frames
        (reference: interface.h:49-80)."""
        if self._fps == 0:
            self._frame += 1
            return
        now = time.monotonic()
        if self._first_time is None:
            self._first_time = now
        frame = math.ceil((now - self._first_time) * self._fps)
        self._frame = frame
        if self._blocking_read:
            ttw = frame * (1.0 / self._fps) - (now - self._first_time)
            if ttw > 0:
                time.sleep(ttw)

    def read_next_depth_frame(self) -> Optional[np.ndarray]:
        """uint16 millimetre depth [H, W], or None at end of stream."""
        raise NotImplementedError

    def get_k(self):
        raise NotImplementedError

    def get_input_size(self):
        """(width, height), reference order."""
        raise NotImplementedError


class RawDepthReader(DepthReader):
    """Packed RAW container reader over a memory map
    (reference: interface.h:199-318)."""

    def __init__(self, filename: str, fps: int = 0,
                 blocking_read: bool = False):
        super().__init__(fps, blocking_read)
        w, h = read_raw_header(filename)
        self._size = (w, h)
        self._mm = np.memmap(filename, dtype=np.uint8, mode="r")
        self._frame_bytes = frame_nbytes(w, h)
        self.camera_open = True

    def read_next_depth_frame(self) -> Optional[np.ndarray]:
        self.get_next_frame()
        w, h = self._size
        off = self._frame_bytes * self._frame
        if off < 0 or off + self._frame_bytes > self._mm.size:
            return None
        return np.frombuffer(
            self._mm[off + 8: off + 8 + w * h * 2], dtype="<u2"
        ).reshape(h, w)

    def get_k(self):
        # Reference default for RAW without -k (interface.h:314-316).
        return (531.15, 531.15, 640 / 2, 480 / 2)

    def get_input_size(self):
        return self._size


class SceneDepthReader(DepthReader):
    """ICL-NUIM scene-directory reader: ASCII ``.depth`` files with
    euclidean ray lengths, converted to planar z
    (reference: interface.h:99-197)."""

    def __init__(self, dirname: str, fps: int = 0,
                 blocking_read: bool = False):
        super().__init__(fps, blocking_read)
        self._dir = dirname
        self._size = SCENE_SIZE
        self.camera_open = os.path.isdir(dirname)
        # Planarization factor (reference: interface.h:182-193).
        w, h = SCENE_SIZE
        fx, fy, cx, cy = SCENE_K
        u = np.arange(w, dtype=np.float32)[None, :]
        v = np.arange(h, dtype=np.float32)[:, None]
        ux = (u - cx) / fx
        vy = (v - cy) / fy
        self._planar = 1.0 / np.sqrt(ux * ux + vy * vy + 1.0)

    def read_next_depth_frame(self) -> Optional[np.ndarray]:
        self.get_next_frame()
        path = os.path.join(self._dir, "scene_00_%04d.depth" % self._frame)
        if not os.path.exists(path):
            return None
        w, h = self._size
        with open(path) as f:
            vals = np.array(f.read().split(), dtype=np.float32)
        depth = vals[: w * h].reshape(h, w)
        depth = depth * self._planar
        # Truncates and does not clip, as the JAX reader does.
        return (depth * 1000.0).astype(np.uint16)

    def get_k(self):
        # Positive-fy convention of the reference reader
        # (reference: interface.h:134-137).
        return (481.20, 480.00, 319.50, 239.50)

    def get_input_size(self):
        return self._size


class NativeBackedRawReader(DepthReader):
    """``RawDepthReader`` drop-in whose frames come from the native
    mmap/prefetch loader (``io/native.py``) while the fps pacing and
    frame dropping stay in ``DepthReader``."""

    def __init__(self, filename: str, fps: int = 0,
                 blocking_read: bool = False):
        super().__init__(fps, blocking_read)
        from slambench_tpu_torch.io import native
        self._native = native.NativeRawReader(filename)
        self._size = self._native.get_input_size()
        self.camera_open = True

    def read_next_depth_frame(self) -> Optional[np.ndarray]:
        self.get_next_frame()
        return self._native.read_depth(self._frame)

    def get_k(self):
        return self._native.get_k()

    def get_input_size(self):
        return self._size


def native_io_enabled() -> bool:
    """False when ``SLAMBENCH_NATIVE_IO`` is ``0`` or ``off`` (the JAX
    package's switch): the numpy readers and converter path then run."""
    return os.environ.get("SLAMBENCH_NATIVE_IO", "1") not in ("0", "off")


def _parse_scf(path: str) -> dict:
    """Parse a ``.scf`` scene-config file: ``key = value`` lines with
    relative paths resolved against the file's directory
    (reference: kfusion/src/reader.cpp:38-170)."""
    base = os.path.dirname(os.path.abspath(path))
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"([A-Za-z_]+)\s*=\s*(.*)", line)
            if m:
                key, val = m.group(1), m.group(2).strip().strip('"')
                if key in ("input_file", "input"):
                    if not os.path.isabs(val):
                        val = os.path.join(base, val)
                out[key] = val
    return out


def make_reader(config) -> Optional[DepthReader]:
    """Reader factory with extension dispatch
    (reference: kfusion/src/reader.cpp:172-207 ``createReader``):
    files -> NativeBackedRawReader (RawDepthReader with
    ``SLAMBENCH_NATIVE_IO=0``), directories -> SceneDepthReader,
    ``.scf`` -> parse (its ``camera`` overrides ``config.camera``) and
    recurse; a missing path gives None."""
    path = config.input_file if hasattr(config, "input_file") else str(config)
    fps = getattr(config, "fps", 0)
    blocking = getattr(config, "blocking_read", False)
    if path.endswith(".scf"):
        scf = _parse_scf(path)
        inner = scf.get("input_file") or scf.get("input")
        if inner is None:
            return None
        if "camera" in scf and hasattr(config, "camera"):
            config.camera = parse_float4(scf["camera"])
            config.camera_overrided = True
        path = inner
    if os.path.isdir(path):
        return SceneDepthReader(path, fps, blocking)
    if os.path.isfile(path):
        if native_io_enabled():
            return NativeBackedRawReader(path, fps, blocking)
        return RawDepthReader(path, fps, blocking)
    return None
