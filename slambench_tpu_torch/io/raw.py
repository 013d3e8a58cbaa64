"""The packed RAW dataset container (a copy of ``slambench_tpu/io/raw.py``).

Byte-compatible with the reference's format so datasets converted by
either tool interoperate. Per frame (reference: interface.h:241-284
``RawDepthReader::readNextDepthFrame`` and scene2raw.cpp:170-176):

    uint32 width, uint32 height, uint16 depth[w*h]   (millimetres, planar z)
    uint32 width, uint32 height, uint8 rgb[w*h*3]

Frames are fixed-size, enabling O(1) seek to any frame index.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def frame_nbytes(width: int, height: int) -> int:
    """Fixed per-frame byte size (reference: interface.h:244-246)."""
    return 4 * 4 + width * height * 2 + width * height * 3


class RawWriter:
    """Stream frames into a RAW container file."""

    def __init__(self, path: str, width: int, height: int):
        self.width = width
        self.height = height
        self._f = open(path, "wb")

    def write(self, depth_mm: np.ndarray, rgb: Optional[np.ndarray] = None
              ) -> None:
        """Append one frame; ``depth_mm`` is uint16 [H, W], ``rgb`` uint8
        [H, W, 3] (zeros if omitted)."""
        h, w = depth_mm.shape
        assert (w, h) == (self.width, self.height)
        hdr = np.array([w, h], dtype="<u4")
        self._f.write(hdr.tobytes())
        self._f.write(np.ascontiguousarray(depth_mm, dtype="<u2").tobytes())
        self._f.write(hdr.tobytes())
        if rgb is None:
            rgb = np.zeros((h, w, 3), np.uint8)
        self._f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_raw_header(path: str) -> Tuple[int, int]:
    """Read (width, height) from the first frame header."""
    with open(path, "rb") as f:
        w, h = np.frombuffer(f.read(8), dtype="<u4")
    return int(w), int(h)


def raw_frame_count(path: str) -> int:
    w, h = read_raw_header(path)
    return os.path.getsize(path) // frame_nbytes(w, h)


def read_raw_frame(path_or_mmap, frame: int,
                   width: Optional[int] = None, height: Optional[int] = None,
                   want_rgb: bool = False):
    """Random-access read of frame ``frame``.

    Accepts a path (opens + seeks, like the reference's
    ``fseek(size_of_frame * _frame)``, interface.h:248) or a pre-built
    ``np.memmap``/bytes-like of the whole file for zero-copy access.
    Returns depth uint16 [H, W] (and rgb uint8 [H, W, 3] if requested), or
    None past end-of-file.
    """
    if isinstance(path_or_mmap, (str, os.PathLike)):
        if width is None:
            width, height = read_raw_header(path_or_mmap)
        data = np.memmap(path_or_mmap, dtype=np.uint8, mode="r")
    else:
        data = path_or_mmap
        assert width is not None and height is not None
    w, h = width, height
    fb = frame_nbytes(w, h)
    off = fb * frame
    if frame < 0 or off + fb > data.size:
        return None
    depth = np.frombuffer(data[off + 8: off + 8 + w * h * 2],
                          dtype="<u2").reshape(h, w)
    if not want_rgb:
        return depth
    roff = off + 16 + w * h * 2
    rgb = np.frombuffer(data[roff: roff + w * h * 3],
                        dtype=np.uint8).reshape(h, w, 3)
    return depth, rgb
