"""Depth-stream readers with the reference's real-time pacing semantics.

A copy of the RAW-file part of ``slambench_tpu/io/readers.py`` (the
JAX package cannot be imported without JAX): ``DepthReader``,
``RawDepthReader`` and ``make_reader``. The native mmap loader, the
ICL-NUIM scene-directory reader and the ONI reader are not ported yet.
(reference: kfusion/include/interface.h:28-318, kfusion/src/reader.cpp)
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np

from slambench_tpu_torch.io.raw import frame_nbytes, read_raw_header


class DepthReader:
    """Base reader: frame counting + fps pacing (reference:
    interface.h:28-87)."""

    def __init__(self, fps: int = 0, blocking_read: bool = False):
        self._frame = -1
        self._fps = fps
        self._blocking_read = blocking_read
        self._first_time: Optional[float] = None
        self.camera_open = False

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


def make_reader(config) -> Optional[DepthReader]:
    """Reader for ``config.input_file``: a ``.raw`` file gives a
    RawDepthReader, a missing path gives None."""
    path = config.input_file if hasattr(config, "input_file") else str(config)
    fps = getattr(config, "fps", 0)
    blocking = getattr(config, "blocking_read", False)
    if path.endswith(".scf") or os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: scene-directory and .scf inputs are not ported yet; "
            "convert to a .raw file")
    if os.path.isfile(path):
        return RawDepthReader(path, fps, blocking)
    return None
