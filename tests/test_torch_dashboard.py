"""The port's live dashboard and viewer (``frontend/dashboard.py``,
``frontend/viewer.py``): the contracts of the JAX package's
``tests/test_frontend_tools.py`` on the port's module, and both front
ends driven end to end on the CPU over a short clip."""

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.frontend import dashboard, viewer  # noqa: E402
from slambench_tpu_torch.frontend.dashboard import (  # noqa: E402
    CLOSED, PAUSED, RUNNING, DashboardState, compose_tile, encode_png,
    load_rc, save_rc, serve)
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
FLAGS = ["-v", "32", "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
         "-r", "1", "-k", "120.3,120.0,80,60"]


# --- PNG encoder -------------------------------------------------------

def test_encode_png_roundtrip_header_and_pixels():
    rgb = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    png = encode_png(rgb)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", png[16:24])
    assert (w, h) == (7, 5)
    # Decode the IDAT payload and undo the per-row filter-0 bytes.
    idat_start = png.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", png[idat_start - 8:idat_start - 4])[0]
    raw = zlib.decompress(png[idat_start:idat_start + idat_len])
    rows = [raw[y * (1 + 7 * 3) + 1:(y + 1) * (1 + 7 * 3)]
            for y in range(5)]
    got = np.frombuffer(b"".join(rows), np.uint8).reshape(5, 7, 3)
    np.testing.assert_array_equal(got, rgb)


def test_compose_tile_layout():
    h, w = 4, 6
    mk = lambda v: np.full((h, w, 3), v, np.uint8)
    grid = compose_tile(mk(10), mk(20), mk(30), raw_rgb=mk(40))
    assert grid.shape == (2 * h, 2 * w, 3)
    assert grid[0, 0, 0] == 40 and grid[0, w, 0] == 10
    assert grid[h, 0, 0] == 20 and grid[h, w, 0] == 30


# --- camera state machine (reference: qt/MainWindow.h:40-42) ----------

def test_state_machine_pause_step_resume():
    s = DashboardState()
    assert s.wait_if_paused() == RUNNING
    s.control("pause")
    s.control("step")
    assert s.wait_if_paused(poll_s=0.001) == "STEP"   # one credit
    s.control("resume")
    assert s.wait_if_paused() == RUNNING
    s.control("quit")
    assert s.wait_if_paused() == CLOSED


def test_breakpoints_pause_the_run():
    s = DashboardState()
    s.control("break_frame", "5")
    s.publish(4, True, True, (0, 0, 0), {}, None)
    assert s.snapshot()["mode"] == RUNNING
    s.publish(5, True, True, (0, 0, 0), {}, None)
    snap = s.snapshot()
    assert snap["mode"] == PAUSED and snap["break_at_frame"] is None
    s.control("resume")
    s.control("break_untracked", "1")
    s.publish(6, False, False, (0, 0, 0), {}, None)
    assert s.snapshot()["mode"] == PAUSED


def test_reset_clears_series():
    s = DashboardState()
    s.publish(0, True, True, (1, 2, 3), {"fps": 2.0}, None)
    s.control("reset")
    assert s.take_reset() is True
    assert s.snapshot()["series"]["fps"] == []
    assert s.take_reset() is False


# --- HTTP surface ------------------------------------------------------

def test_http_endpoints_serve_state_and_controls():
    s = DashboardState()
    tile = encode_png(np.zeros((2, 2, 3), np.uint8))
    s.publish(7, True, False, (0.1, 0.2, 0.3), {"fps": 1.5}, tile)
    httpd = serve(s, port=0)
    port = httpd.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        stats = json.loads(urllib.request.urlopen(
            base + "/stats.json", timeout=5).read())
        assert stats["frame"] == 7 and stats["series"]["fps"] == [1.5]
        png = urllib.request.urlopen(base + "/tile.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # Mutations need the per-run CSRF token (embedded in the page).
        html = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"dashboard" in html and s.token.encode() in html
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/control?cmd=pause", timeout=5)
        assert e.value.code == 403
        body = urllib.request.urlopen(
            base + f"/control?cmd=pause&token={s.token}", timeout=5).read()
        assert body == b"PAUSED"
    finally:
        httpd.shutdown()


def test_http_reconfig_endpoint_queues_changes():
    """Runtime parameter reconfiguration (the reference's Qt dropdown
    rebuild, qt/SlamBenchQt.cpp:347-362) over HTTP."""
    s = DashboardState()
    httpd = serve(s, port=0)
    port = httpd.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                base + "/reconfig?volume_resolution=128", timeout=5)
        assert e.value.code == 403
        body = urllib.request.urlopen(
            base + f"/reconfig?volume_resolution=128&integration_rate=3"
                   f"&token={s.token}", timeout=5).read()
        assert body == b"RECONFIG"
        assert s.take_reconfig() == {"volume_resolution": "128",
                                     "integration_rate": "3"}
        assert s.take_reconfig() is None
    finally:
        httpd.shutdown()


def test_series_history_is_bounded():
    s = DashboardState()
    for i in range(DashboardState.MAX_POINTS + 50):
        s.publish(i, True, True, (0, 0, 0), {"fps": float(i)}, None)
    assert len(s.series["fps"]) == DashboardState.MAX_POINTS
    assert s.series["fps"][-1] == float(DashboardState.MAX_POINTS + 49)


def test_http_mesh_endpoint():
    """Live /mesh.ply export of the current reconstruction (beyond the
    reference's Qt GUI; mesh bytes come from tools/mesh_export)."""
    import numpy as np

    from slambench_tpu_torch.tools.mesh_export import ply_bytes, surface_nets

    s = DashboardState()
    httpd = serve(s, port=0)
    port = httpd.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        # No provider yet: 503, not a crash.
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/mesh.ply", timeout=5)
        assert e.value.code == 503

        i = (np.arange(24) + 0.5) / 24
        z, y, x = np.meshgrid(i, i, i, indexing="ij")
        vol = np.clip((np.sqrt((x - .5) ** 2 + (y - .5) ** 2
                               + (z - .5) ** 2) - 0.3) * 6, -1, 1)
        s.mesh_provider = lambda: ply_bytes(
            *surface_nets(vol.astype(np.float32), dim=(2.0,) * 3))
        body = urllib.request.urlopen(base + "/mesh.ply", timeout=5).read()
        assert body.startswith(b"ply\nformat binary_little_endian")
        assert b"element face" in body[:200]
    finally:
        httpd.shutdown()


# --- rc persistence (reference: .kfusion_kinectrc) ---------------------

def test_rc_save_load_roundtrip(tmp_path):
    rc = str(tmp_path / "rc")
    argv = ["-i", "scene.raw", "-c", "2"]
    save_rc(argv, rc)
    assert load_rc(rc) == argv
    assert load_rc(str(tmp_path / "missing")) is None


def test_http_servers_close_their_socket():
    s = DashboardState()
    httpd = serve(s, port=0)
    port = httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/stats.json",
                               timeout=2)


# --- the front ends on a short clip -----------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dash_clip"))
    return TS.generate_dataset(out, CPU, n_frames=6, image_size=(160, 120),
                               dim=(4.8, 4.8, 4.8), amp=0.12)


def test_run_dashboard_serves_a_running_scene(clip, tmp_path, monkeypatch):
    """run_dashboard on the CPU: start paused, break at frame 3, read
    /stats.json, a 2H x 2W /tile.png and a non-empty /mesh.ply, reconfig
    and quit; the scene's arguments go to the rc file."""
    rc_path = str(tmp_path / "rc")
    monkeypatch.setattr(dashboard, "RC_PATH", rc_path)
    argv = ["--device", "cpu", "--port", "0", "--every", "1", "--paused",
            "-i", clip["raw"], *FLAGS]
    served, out = threading.Event(), {}

    def on_serve(dash, httpd):
        out["dash"], out["httpd"] = dash, httpd
        served.set()

    th = threading.Thread(target=lambda: out.setdefault(
        "rc", dashboard.run_dashboard(list(argv), on_serve=on_serve)),
        daemon=True)
    th.start()
    assert served.wait(60)
    dash = out["dash"]
    base = f"http://127.0.0.1:{out['httpd'].server_address[1]}"
    try:
        assert dash.snapshot()["params"]["device"] == "cpu"
        dash.control("break_frame", "3")
        dash.control("resume")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            snap = dash.snapshot()
            if snap["mode"] == PAUSED and snap["frame"] >= 3:
                break
            time.sleep(0.02)
        stats = json.loads(urllib.request.urlopen(
            base + "/stats.json", timeout=10).read())
        assert stats["frame"] == 3 and stats["mode"] == PAUSED
        assert set(stats["series"]) >= {"fps", "X", "Y", "Z"}
        png = urllib.request.urlopen(base + "/tile.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert struct.unpack(">II", png[16:24]) == (2 * 160, 2 * 120)
        ply = urllib.request.urlopen(base + "/mesh.ply", timeout=60).read()
        head = ply[:200].decode("ascii", "replace")
        assert int(head.split("element vertex ")[1].split()[0]) > 0
        body = urllib.request.urlopen(
            base + f"/reconfig?integration_rate=2&token={dash.token}",
            timeout=10).read()
        assert body == b"RECONFIG"
        t0 = time.monotonic()
        while dash.snapshot()["params"]["integration_rate"] != 2:
            assert time.monotonic() - t0 < 30
            time.sleep(0.02)
    finally:
        dash.control("quit")
        th.join(60)
    assert not th.is_alive() and out["rc"] == 0
    assert load_rc(rc_path) == argv[argv.index("-i"):]


def test_viewer_writes_png_tiles(clip, tmp_path):
    """run_viewer on the CPU writes a PNG tile every --every frames
    (through the dashboard's encoder: no PIL), latest.png and the index."""
    out_dir = str(tmp_path / "view")
    assert viewer.run_viewer(["--device", "cpu", "--out-dir", out_dir,
                              "--every", "2", "-i", clip["raw"],
                              *FLAGS]) == 0
    files = sorted(os.listdir(out_dir))
    assert files == ["frame_000000.png", "frame_000002.png",
                     "frame_000004.png", "index.html", "latest.png"]
    with open(os.path.join(out_dir, "frame_000004.png"), "rb") as f:
        png = f.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (320, 240)


def test_save_tile_layout(tmp_path):
    h, w = 3, 5
    mk = lambda v: np.full((h, w, 4), v, np.uint8)   # noqa: E731
    path = str(tmp_path / "t.png")
    viewer.save_tile(path, mk(10), mk(20), mk(30))
    with open(path, "rb") as f:
        png = f.read()
    i = png.index(b"IDAT") + 4
    n = struct.unpack(">I", png[i - 8:i - 4])[0]
    raw = zlib.decompress(png[i:i + n])
    rows = [raw[y * (1 + 2 * w * 3) + 1:(y + 1) * (1 + 2 * w * 3)]
            for y in range(2 * h)]
    grid = np.frombuffer(b"".join(rows), np.uint8).reshape(2 * h, 2 * w, 3)
    np.testing.assert_array_equal(grid, compose_tile(mk(10), mk(20), mk(30)))
