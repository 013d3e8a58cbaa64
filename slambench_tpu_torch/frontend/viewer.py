"""Lightweight visual front-end: the 2x2 diagnostic tile of the
reference GUIs, rendered to PNG files (and an auto-refreshing HTML
index) instead of a GLUT/Qt window (port of
``slambench_tpu/frontend/viewer.py``).

Equivalent surface to the reference's GLUT ``drawthem`` 2x2 layout
(reference: kfusion/include/draw.h:50-108 — RGB/depth/track/volume
tiles) and the Qt viewer grid (reference: qt/MainWindow.cpp); the
machines with the card are headless, so the streams land on disk where a
browser or a notebook can watch them. The PNG comes from the dashboard's
own encoder (``frontend/dashboard.encode_png``, zlib only): the JAX
viewer writes through PIL and, without it, silently writes nothing.

Usage:
  python -m slambench_tpu_torch.frontend.viewer -i scene.raw \\
      --out-dir DIR [same pipeline flags as the benchmark]
      [--device cuda|cpu] [--every N]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from slambench_tpu_torch.frontend.dashboard import (
    take_flag, compose_tile, encode_png,
)

INDEX_HTML = """<!doctype html>
<html><head><meta http-equiv="refresh" content="1">
<title>slambench_tpu_torch viewer</title></head>
<body style="background:#222;color:#eee;font-family:monospace">
<h3>slambench_tpu_torch — live diagnostic streams</h3>
<img src="latest.png" style="image-rendering:pixelated;width:90%">
</body></html>
"""


def save_tile(path: str, depth_rgba, track_rgba, volume_rgba,
              raw_depth=None) -> None:
    """Compose the 2x2 tile (raw depth colormap / filtered depth /
    track diagnostics / volume render) and write it as a PNG."""
    grid = compose_tile(depth_rgba, track_rgba, volume_rgba, raw_depth)
    with open(path, "wb") as f:
        f.write(encode_png(grid))


def run_viewer(argv=None) -> int:
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.frontend.benchmark import make_kfusion
    from slambench_tpu_torch.io.readers import make_reader
    from slambench_tpu_torch.policy import (
        apply_precision_policy, resolve_device,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = take_flag(argv, "--out-dir", os.path.join(
        tempfile.gettempdir(), "slambench_tpu_torch_view"))
    every = int(take_flag(argv, "--every", "4"))
    device = resolve_device(take_flag(argv, "--device", "cuda"))

    config = parse_args(argv)
    reader = make_reader(config)
    if reader is None:
        print("No input found.", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(INDEX_HTML)
    apply_precision_policy()
    kf = make_kfusion(config, reader, device)
    state = kf.init_state()

    frame = 0
    while True:
        depth = reader.read_next_depth_frame()
        if depth is None:
            break
        state = kf.process_frame(
            state, np.ascontiguousarray(depth), frame,
            config.tracking_rate, config.integration_rate)
        if frame % every == 0:
            d_img, t_img, v_img = (img.cpu().numpy() for img in (
                kf.render_depth_image(state), kf.render_track_image(state),
                kf.render_volume_image(state)))
            path = os.path.join(out_dir, f"frame_{frame:06d}.png")
            save_tile(path, d_img, t_img, v_img)
            latest = os.path.join(out_dir, "latest.png")
            try:
                if os.path.exists(latest):
                    os.unlink(latest)
                os.link(path, latest)
            except OSError:
                pass
            print(f"frame {frame} -> {path}", file=sys.stderr)
        frame += 1
    return 0


if __name__ == "__main__":
    raise SystemExit(run_viewer())
