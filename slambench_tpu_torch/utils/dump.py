"""Per-frame debug dump helpers for cross-implementation diffing.

A copy of ``slambench_tpu/utils/dump.py`` (the port imports nothing
of the JAX package).

Equivalents of the reference's determinism/accuracy artifacts
(reference: kfusion/include/commons.h:520-567): ``writefile`` dumps any
buffer raw-binary to ``<prefix><idx>``; ``writeposfile`` writes a pose
both raw-binary (``BINARY_<prefix><idx>``) and as a 4-line ASCII matrix.
Together with the epsilon comparators (utils/compare.py) these support
the reference's debugging workflow: dump the same buffer from two
implementations (here: the port vs the JAX package, or the oracle
march vs the min-mip march) and diff frame by frame.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def write_buffer(prefix: str, idx: int, data, out=sys.stdout) -> int:
    """Raw-binary dump of any array to ``<prefix><idx>`` (reference:
    commons.h:520-541 writefile). Returns the element count written."""
    arr = np.ascontiguousarray(np.asarray(data))
    filename = f"{prefix}{idx}"
    with open(filename, "wb") as f:
        arr.tofile(f)
    print(f"File {filename} of size {arr.size}", file=out)
    return arr.size


def write_pose(prefix: str, idx: int, pose, out=sys.stdout) -> None:
    """Dump a 4x4 pose binary + ASCII (reference: commons.h:543-567
    writeposfile: BINARY_<prefix><idx> holds the 16 float32s; the text
    file holds 4 rows of 4)."""
    m = np.asarray(pose, dtype=np.float32).reshape(4, 4)
    head, tail = os.path.split(prefix)
    write_buffer(os.path.join(head, "BINARY_" + tail), idx, m, out=out)
    filename = f"{prefix}{idx}"
    with open(filename, "w") as f:
        for row in m:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    print(f"Pose File {filename}", file=out)


def read_buffer(prefix: str, idx: int, dtype, shape=None) -> np.ndarray:
    """Load a dump back (the offline-diff half of the workflow)."""
    arr = np.fromfile(f"{prefix}{idx}", dtype=dtype)
    return arr.reshape(shape) if shape is not None else arr
