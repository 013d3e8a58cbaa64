"""OpenNI recording (.oni) -> RAW converter.

The port's copy of ``slambench_tpu/tools/oni2raw.py``, the equivalent
of the reference's ``oni2raw`` (reference:
kfusion/thirdparty/oni2raw.cpp:76-255), which replays a Kinect
recording through the OpenNI runtime and repacks the depth stream into
the packed RAW container. The benchmark's hosts have no OpenNI stack,
so the .oni container is parsed directly
(:mod:`slambench_tpu_torch.io.oni` — record stream walk, UNC_/16z depth
codecs; see that module's fidelity caveat).

Two input modes:
  * ``foo.oni``      — native ONI recording (container parsed here);
  * a directory      — per-frame ``.npy``/``.png`` millimetre-uint16
    depth dumps, the intermediate format OpenNI tooling can export
    anywhere (kept from the earlier capability boundary).

CLI: python -m slambench_tpu_torch.tools.oni2raw <in.oni | dump_dir> <out.raw>
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from slambench_tpu_torch.io.raw import RawWriter


def convert_oni(oni_path: str, out_path: str) -> int:
    from slambench_tpu_torch.io.oni import OniReader
    rd = OniReader(oni_path)
    writer = None
    n = 0
    try:
        for depth in rd.depth_frames():
            if writer is None:
                h, w = depth.shape
                writer = RawWriter(out_path, w, h)
            writer.write(depth)
            n += 1
    finally:
        if writer:
            writer.close()
        rd.close()
    node = rd.depth_node
    if node is not None:
        print(f"depth node {node.name.decode(errors='replace')!r} "
              f"codec {node.codec!r} {node.resolution[0]}x"
              f"{node.resolution[1]}", file=sys.stderr)
    print(f"wrote {n} frames to {out_path}", file=sys.stderr)
    return n


def convert(dump_dir: str, out_path: str) -> int:
    files = sorted(
        f for f in os.listdir(dump_dir)
        if re.match(r".*\.(npy|png)$", f))
    if not files:
        print("no .npy/.png depth frames found (for native .oni files, "
              "pass the .oni path itself)", file=sys.stderr)
        return 0
    writer = None
    n = 0
    for f in files:
        path = os.path.join(dump_dir, f)
        if f.endswith(".npy"):
            depth = np.load(path)
        else:
            from PIL import Image
            depth = np.asarray(Image.open(path))
        depth = np.asarray(depth, np.uint16)
        if writer is None:
            h, w = depth.shape
            writer = RawWriter(out_path, w, h)
        writer.write(depth)
        n += 1
    if writer:
        writer.close()
    print(f"wrote {n} frames to {out_path}", file=sys.stderr)
    return n


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: oni2raw <in.oni | dump_dir> <out.raw>",
              file=sys.stderr)
        return 1
    src = argv[0]
    if os.path.isdir(src):
        return 0 if convert(src, argv[1]) > 0 else 1
    return 0 if convert_oni(src, argv[1]) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
