"""ICL-NUIM scene directory -> packed RAW converter (the port's copy of
``slambench_tpu/tools/scene2raw.py``).

Equivalent of the reference converter (reference:
kfusion/thirdparty/scene2raw.cpp:76-187): reads ``scene_00_NNNN.depth``
ASCII files (euclidean ray lengths) and optional ``scene_00_NNNN.png``
color frames, undoes the euclidean->planar conversion with the ICL-NUIM
intrinsics (reference: scene2raw.cpp:97-109), quantizes to millimetre
uint16 and streams frames into the RAW container.

The native parser and planarizer (``io/native.py``, the port's build of
libslamio; ~30x faster than Python float parsing) run unless
``SLAMBENCH_NATIVE_IO=0`` selects the numpy path; a failed native build
raises. PIL is imported only to read ``.png`` colour frames; without it
no RGB is written.

CLI: python -m slambench_tpu_torch.tools.scene2raw <scene_dir> <out.raw>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from slambench_tpu_torch.io import native
from slambench_tpu_torch.io.raw import RawWriter
from slambench_tpu_torch.io.readers import (
    SCENE_K, SCENE_SIZE, native_io_enabled,
)


def convert(scene_dir: str, out_path: str, verbose: bool = True) -> int:
    w, h = SCENE_SIZE
    fx, fy, cx, cy = SCENE_K
    use_native = native_io_enabled()

    try:
        from PIL import Image
        have_pil = True
    except ImportError:
        have_pil = False

    # Planarization factor of the numpy path.
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    planar = 1.0 / np.sqrt(((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2 + 1.0)

    frame = 0
    writer = None
    while True:
        dpath = os.path.join(scene_dir, "scene_00_%04d.depth" % frame)
        if not os.path.exists(dpath):
            break
        if use_native:
            euclid = native.parse_depth_ascii(dpath, w * h).reshape(h, w)
            depth_mm = native.planarize_mm(euclid, fx, fy, cx, cy)
        else:
            with open(dpath) as f:
                vals = np.array(f.read().split()[: w * h], np.float32)
            euclid = vals.reshape(h, w)
            depth_mm = np.clip(euclid * planar * 1000.0, 0,
                               65535).astype(np.uint16)

        rgb = None
        ppath = os.path.join(scene_dir, "scene_00_%04d.png" % frame)
        if have_pil and os.path.exists(ppath):
            rgb = np.asarray(Image.open(ppath).convert("RGB"), np.uint8)

        if writer is None:
            writer = RawWriter(out_path, w, h)
        writer.write(depth_mm, rgb)
        if verbose and frame % 50 == 0:
            print(f"frame {frame}", file=sys.stderr)
        frame += 1

    if writer:
        writer.close()
    if verbose:
        print(f"wrote {frame} frames to {out_path}", file=sys.stderr)
    return frame


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: scene2raw <scene_dir> <out.raw>", file=sys.stderr)
        return 1
    n = convert(argv[0], argv[1])
    return 0 if n > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
