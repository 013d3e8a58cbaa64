"""Live web dashboard: the interactive-GUI surface of the reference (port
of ``slambench_tpu/frontend/dashboard.py``).

The machines with the card are headless, so the reference's Qt application
(reference: kfusion/qt/ApplicationWindow.{h,cpp}, MainWindow.{h,cpp},
SlamBenchQt.cpp) is re-designed as a zero-dependency HTTP dashboard that
exposes the same capabilities:

* the viewer grid of live streams — raw depth / filtered depth / ICP
  diagnostics / volume render (reference: qt/MainWindow.cpp viewers,
  include/draw.h:50-108 2x2 GLUT tile),
* live stat plots of every PerfStats series + power samples, drawn
  client-side on a <canvas> (reference: vendored qcustomplot graphs,
  qt/SlamBenchQt.cpp:399-414),
* the camera state machine RUNNING / PAUSED / STEP / CLOSED with
  pause/resume/single-step/restart controls (reference:
  qt/MainWindow.h:40-42 states; 'restart scene' rebuild,
  SlamBenchQt.cpp:83-127),
* re-render while paused without consuming a frame (the ``forceRender``
  path, reference: qt/SlamBenchQt.cpp:50-52,253-255),
* frame / tracking-failure breakpoints settable at runtime (reference:
  ApplicationWindow.cpp:1024-1060),
* CLI-argument persistence to ``~/.slambench_tpu_torch_rc`` so a bare
  ``python -m slambench_tpu_torch.frontend.dashboard`` reopens the last
  scene
  (reference: .kfusion_kinectrc, ApplicationWindow.h:226-227,
  cpp:172-192,263-276).

The pipeline (``pipeline.KFusion`` on ``--device``, the card unless
``--device cpu``) runs in the calling thread; an http.server thread
serves state snapshots — the Python analogue of Qt's idle-loop pump
(reference: ApplicationWindow.cpp:450 ``startTimer(0)``). The tile is the
port's depth, track and volume renders; ``/mesh.ply`` triangulates a
host copy of the TSDF with ``tools/mesh_export.py``; ``/reconfig``
rebuilds the ``KFusion``. Everything but ``run_dashboard`` is the
standard library and numpy, as in JAX.

Usage:
  python -m slambench_tpu_torch.frontend.dashboard -i scene.raw
      [pipeline flags] [--device cuda|cpu] [--port 8080] [--every 2]
      [--paused]
"""

from __future__ import annotations

import json
import os
import secrets
import struct
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

RC_PATH = os.path.expanduser("~/.slambench_tpu_torch_rc")

# Camera states (reference: qt/MainWindow.h:40-42 — UNINITIALISED /
# RUNNING / PAUSED / CLOSED / LIVE; LIVE needs a camera, absent here).
RUNNING, PAUSED, CLOSED = "RUNNING", "PAUSED", "CLOSED"


def save_rc(argv: List[str], path: Optional[str] = None) -> None:
    """Persist the scene arguments (reference: ApplicationWindow.cpp:
    263-276 writes .kfusion_kinectrc on exit); ``path`` defaults to
    ``RC_PATH``."""
    path = RC_PATH if path is None else path
    try:
        with open(path, "w") as f:
            json.dump({"argv": argv}, f)
    except OSError:
        pass


def load_rc(path: Optional[str] = None) -> Optional[List[str]]:
    """Recover the previous scene arguments (reference:
    ApplicationWindow.cpp:172-192 reads the rc at startup); ``path``
    defaults to ``RC_PATH``."""
    path = RC_PATH if path is None else path
    try:
        with open(path) as f:
            argv = json.load(f).get("argv")
            return list(argv) if argv else None
    except (OSError, ValueError):
        return None


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib only) so the dashboard has
    zero image-library dependencies — the role lodepng plays in the
    reference's converters (kfusion/thirdparty/lodepng)."""
    arr = np.ascontiguousarray(rgb[..., :3], dtype=np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def compose_tile(depth_rgb, track_rgb, volume_rgb, raw_rgb=None
                 ) -> np.ndarray:
    """2x2 diagnostic grid (reference: draw.h:74-108 drawthem layout)."""
    d = np.asarray(depth_rgb)[..., :3]
    h, w = d.shape[:2]
    grid = np.zeros((2 * h, 2 * w, 3), np.uint8)
    grid[:h, :w] = (np.asarray(raw_rgb)[..., :3]
                    if raw_rgb is not None else d)
    grid[:h, w:] = d
    grid[h:, :w] = np.asarray(track_rgb)[..., :3]
    grid[h:, w:] = np.asarray(volume_rgb)[..., :3]
    return grid


class DashboardState:
    """Shared, lock-protected snapshot the HTTP thread serves and the
    pipeline thread updates; also carries the control state machine."""

    # Series history cap: snapshot() only transports this many points, so
    # anything beyond it would be a slow per-frame memory leak.
    MAX_POINTS = 600

    def __init__(self):
        self.lock = threading.Lock()
        self.mode = RUNNING
        self.step_request = 0          # outstanding single-step credits
        self.render_request = False    # forceRender while paused
        self.reset_request = False
        self.frame = 0
        self.tracked = False
        self.integrated = False
        self.pose = (0.0, 0.0, 0.0)
        self.tile_png: bytes = b""
        self.series: Dict[str, List[float]] = {}
        self.params: Dict[str, object] = {}
        # Runtime breakpoints (reference: ApplicationWindow.cpp:1024-1060).
        self.break_at_frame: Optional[int] = None
        self.break_on_untracked = False
        # Pending runtime parameter change (reference rebuilds the Kfusion
        # object when GUI dropdowns change, qt/SlamBenchQt.cpp:347-362).
        self.reconfig_request: Optional[Dict[str, str]] = None
        # Per-run CSRF token: mutating endpoints require it, so a foreign
        # web page cannot fire cross-origin /control?cmd=quit at the
        # loopback server.
        self.token = secrets.token_hex(8)
        # /mesh.ply provider (set by the run loop): () -> PLY bytes of
        # the CURRENT reconstruction (tools/mesh_export surface nets) —
        # a live-export capability the reference's Qt GUI lacks.
        self.mesh_provider = None
        # Volume-snapshot handshake for /mesh.ply: the HTTP thread never
        # touches the pipeline's device tensors (a read from another
        # thread would race the frame step's queued work on the stream).
        # The HTTP thread sets ``mesh_request``; the pipeline thread
        # copies the TSDF to the host between frames, stores it in
        # ``mesh_tsdf`` and sets ``mesh_ready``.
        self.mesh_request = threading.Event()
        self.mesh_ready = threading.Event()
        self.mesh_tsdf = None    # np.float32 [Z, Y, X] snapshot

    # Pipeline-side -----------------------------------------------------
    def publish(self, frame: int, tracked: bool, integrated: bool,
                pose, samples: Dict[str, float],
                tile_png: Optional[bytes]) -> None:
        with self.lock:
            self.frame = frame
            self.tracked = tracked
            self.integrated = integrated
            self.pose = tuple(float(p) for p in pose)
            for k, v in samples.items():
                lst = self.series.setdefault(k, [])
                lst.append(float(v))
                if len(lst) > self.MAX_POINTS:
                    del lst[:-self.MAX_POINTS]
            if tile_png is not None:
                self.tile_png = tile_png
            if self.break_on_untracked and frame > 3 and not tracked:
                self.mode = PAUSED
            if self.break_at_frame is not None \
                    and frame >= self.break_at_frame:
                self.mode = PAUSED
                self.break_at_frame = None

    def wait_if_paused(self, poll_s: float = 0.05, idle_cb=None) -> str:
        """Block while PAUSED (unless a step credit is pending); returns
        the mode that allowed progress ('RUNNING'/'STEP'/'CLOSED').
        ``idle_cb`` runs each poll iteration on the pipeline thread —
        used to service /mesh.ply snapshot requests while paused."""
        while True:
            if idle_cb is not None:
                idle_cb()
            with self.lock:
                if self.mode == CLOSED:
                    return CLOSED
                if self.mode == RUNNING:
                    return RUNNING
                if self.step_request > 0:
                    self.step_request -= 1
                    return "STEP"
                if self.reset_request:
                    return "RESET"
                if self.reconfig_request is not None:
                    return "RECONFIG"
                rerender = self.render_request
                self.render_request = False
            if rerender:
                return "RENDER"
            time.sleep(poll_s)

    def take_reset(self) -> bool:
        with self.lock:
            r = self.reset_request
            self.reset_request = False
            if r:
                for v in self.series.values():
                    v.clear()
            return r

    def request_reconfig(self, changes: Dict[str, str]) -> None:
        with self.lock:
            self.reconfig_request = dict(changes)

    def take_reconfig(self) -> Optional[Dict[str, str]]:
        with self.lock:
            r = self.reconfig_request
            self.reconfig_request = None
            return r

    # Control-side ------------------------------------------------------
    def control(self, cmd: str, arg: Optional[str] = None) -> str:
        with self.lock:
            if cmd == "pause":
                self.mode = PAUSED
            elif cmd == "resume":
                self.mode = RUNNING
            elif cmd == "step":
                self.mode = PAUSED
                self.step_request += 1
            elif cmd == "render":
                self.render_request = True
            elif cmd == "reset":
                self.reset_request = True
            elif cmd == "quit":
                self.mode = CLOSED
            elif cmd == "break_frame":
                self.break_at_frame = int(arg) if arg else None
            elif cmd == "break_untracked":
                self.break_on_untracked = bool(int(arg or "0"))
            else:
                return f"unknown command {cmd!r}"
            return self.mode

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "mode": self.mode,
                "frame": self.frame,
                "tracked": self.tracked,
                "integrated": self.integrated,
                "pose": list(self.pose),
                "series": {k: v[-600:] for k, v in self.series.items()},
                "params": self.params,
                "break_at_frame": self.break_at_frame,
                "break_on_untracked": self.break_on_untracked,
            }


PAGE = """<!doctype html>
<html><head><title>slambench_tpu_torch dashboard</title><style>
body{background:#1b1b1f;color:#e8e8ea;font-family:monospace;margin:16px}
button{background:#2d2d33;color:#e8e8ea;border:1px solid #555;
  padding:4px 12px;margin-right:6px;cursor:pointer}
canvas{background:#232327;display:block;margin:4px 0}
#tile{image-rendering:pixelated;width:640px}
.plot{display:inline-block;margin-right:12px;vertical-align:top}
.lbl{color:#9a9aa2;font-size:12px}
</style></head><body>
<h3>slambench_tpu_torch &mdash; live dashboard</h3>
<div id="status" class="lbl"></div>
<p>
<button onclick="ctl('pause')">pause</button>
<button onclick="ctl('resume')">resume</button>
<button onclick="ctl('step')">step</button>
<button onclick="ctl('render')">re-render</button>
<button onclick="ctl('reset')">restart scene</button>
<button onclick="ctl('quit')">quit</button>
&nbsp; break at frame <input id="bf" size="5">
<button onclick="ctl('break_frame',document.getElementById('bf').value)">
set</button>
<button onclick="ctl('break_untracked','1')">break on untracked</button>
&nbsp; <a href="/mesh.ply" download="reconstruction.ply"
   style="color:#8ab4f8">download mesh (.ply)</a>
</p>
<p class="lbl">runtime parameters (rebuilds the pipeline, resets state):
volume-resolution <input id="rc_vr" size="4">
integration-rate <input id="rc_ir" size="3">
tracking-rate <input id="rc_tr" size="3">
mu <input id="rc_mu" size="5">
icp-threshold <input id="rc_icp" size="7">
backend <input id="rc_be" size="6">
<button onclick="reconfig()">apply</button>
</p>
<img id="tile" src="/tile.png">
<div id="plots"></div>
<script>
const TOKEN='__TOKEN__';
function ctl(cmd, arg){fetch('/control?cmd='+cmd+(arg?'&arg='+arg:'')+
  '&token='+TOKEN,{method:'POST'})}
function reconfig(){
  const fields={volume_resolution:'rc_vr',integration_rate:'rc_ir',
    tracking_rate:'rc_tr',mu:'rc_mu',icp_threshold:'rc_icp',
    backend:'rc_be'};
  let parts=[];
  for(let k in fields){
    let v=document.getElementById(fields[k]).value.trim();
    if(v)parts.push(k+'='+encodeURIComponent(v));}
  if(parts.length)
    fetch('/reconfig?'+parts.join('&')+'&token='+TOKEN,{method:'POST'});
}
function draw(name, data){
  let id='p_'+name.replace(/[^a-zA-Z0-9]/g,'_');
  let div=document.getElementById(id);
  if(!div){div=document.createElement('div');div.id=id;
    div.className='plot';
    div.innerHTML='<span class="lbl">'+name+': <span class="v"></span>'+
      '</span><canvas width="280" height="70"></canvas>';
    document.getElementById('plots').appendChild(div);}
  let c=div.querySelector('canvas'),x=c.getContext('2d');
  x.clearRect(0,0,c.width,c.height);
  if(!data.length)return;
  let mx=Math.max(...data),mn=Math.min(...data),r=(mx-mn)||1;
  x.strokeStyle='#7aa2f7';x.beginPath();
  data.forEach((v,i)=>{let px=i/(data.length-1||1)*c.width,
    py=c.height-4-(v-mn)/r*(c.height-8);
    i?x.lineTo(px,py):x.moveTo(px,py);});
  x.stroke();
  div.querySelector('.v').textContent=data[data.length-1].toPrecision(4);
}
async function tick(){
  try{
    let s=await (await fetch('/stats.json')).json();
    document.getElementById('status').textContent=
      'mode='+s.mode+' frame='+s.frame+' tracked='+s.tracked+
      ' pose=['+s.pose.map(v=>v.toFixed(3)).join(', ')+']';
    for(let k in s.series) draw(k, s.series[k]);
    document.getElementById('tile').src='/tile.png?t='+Date.now();
  }catch(e){}
  setTimeout(tick, 500);
}
tick();
</script></body></html>
"""


def make_handler(state: DashboardState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _check_token(self, q) -> bool:
            """CSRF guard: mutating endpoints need the per-run token the
            served page embeds; a foreign origin cannot read it."""
            return q.get("token", [""])[0] == state.token

        def _mutate(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/control":
                if not self._check_token(q):
                    self._send(403, "text/plain", b"bad token")
                    return
                cmd = q.get("cmd", [""])[0]
                arg = q.get("arg", [None])[0]
                self._send(200, "text/plain",
                           state.control(cmd, arg).encode())
            elif url.path == "/reconfig":
                if not self._check_token(q):
                    self._send(403, "text/plain", b"bad token")
                    return
                changes = {k: v[0] for k, v in q.items() if k != "token"}
                state.request_reconfig(changes)
                self._send(200, "text/plain", b"RECONFIG")
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            self._mutate()

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html",
                           PAGE.replace("__TOKEN__", state.token).encode())
            elif url.path == "/tile.png":
                png = state.tile_png or encode_png(
                    np.zeros((8, 8, 3), np.uint8))
                self._send(200, "image/png", png)
            elif url.path == "/stats.json":
                self._send(200, "application/json",
                           json.dumps(state.snapshot()).encode())
            elif url.path == "/mesh.ply":
                provider = state.mesh_provider
                if provider is None:
                    self._send(503, "text/plain", b"no mesh provider")
                    return
                try:
                    body = provider()
                except Exception as e:    # surface errors to the client
                    self._send(500, "text/plain", str(e).encode())
                    return
                self._send(200, "application/octet-stream", body)
            elif url.path in ("/control", "/reconfig"):
                # Token-guarded GET kept for curl convenience; the token
                # is the CSRF defense either way.
                self._mutate()
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(state: DashboardState, port: int = 0) -> ThreadingHTTPServer:
    """Start the HTTP thread; returns the server (``.server_address`` has
    the bound port)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def take_flag(argv: List[str], flag: str, default: Optional[str]
               ) -> Optional[str]:
    """Remove ``flag VALUE`` from ``argv``; the value (or ``default``)."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def run_dashboard(argv=None, on_serve=None) -> int:
    """Serve the dashboard and run the scene until ``quit``.
    ``on_serve(dash, httpd)``, when given, is called once the server is
    up (a caller that drives the controls itself, from another thread,
    uses it to find the state and the bound port)."""
    from slambench_tpu_torch.config import VALID_BACKENDS, parse_args
    from slambench_tpu_torch.frontend.benchmark import make_kfusion
    from slambench_tpu_torch.io.readers import make_reader
    from slambench_tpu_torch.policy import (
        apply_precision_policy, resolve_device,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    port = int(take_flag(argv, "--port", "8080"))
    every = int(take_flag(argv, "--every", "2"))
    device = resolve_device(take_flag(argv, "--device", "cuda"))
    start_paused = "--paused" in argv
    if start_paused:
        argv.remove("--paused")

    if not argv:
        prev = load_rc()
        if prev:
            print(f"restoring scene from {RC_PATH}: {' '.join(prev)}",
                  file=sys.stderr)
            argv = prev
    config = parse_args(argv)
    if not config.input_file:
        print("No input found (and no saved rc).", file=sys.stderr)
        return 1
    save_rc(argv)

    reader = make_reader(config)
    if reader is None:
        print("No input found.", file=sys.stderr)
        return 1
    apply_precision_policy()

    def build_kf():
        kf = make_kfusion(config, reader, device)
        return kf, kf.init_state()

    def current_params():
        return {
            "input": config.input_file,
            "device": str(device),
            "volume_resolution": list(config.volume_resolution),
            "volume_size": list(config.volume_size),
            "compute_size_ratio": config.compute_size_ratio,
            "mu": config.mu,
            "icp_threshold": config.icp_threshold,
            "tracking_rate": config.tracking_rate,
            "integration_rate": config.integration_rate,
            "backend": config.backend,
        }

    def apply_reconfig(changes) -> bool:
        """Apply runtime parameter changes to the config; returns whether
        the pipeline must be rebuilt (the reference rebuilds Kfusion and
        resets on volume/ratio changes, qt/SlamBenchQt.cpp:347-362)."""
        rebuild = False
        for key, val in changes.items():
            try:
                if key == "volume_resolution":
                    n = int(val)
                    config.volume_resolution = (n, n, n)
                    rebuild = True
                elif key == "mu":
                    config.mu = float(val)
                    rebuild = True
                elif key == "icp_threshold":
                    config.icp_threshold = float(val)
                    rebuild = True
                elif key == "backend":
                    if val in VALID_BACKENDS:
                        config.backend = val
                        rebuild = True
                elif key == "integration_rate":
                    config.integration_rate = max(1, int(val))
                elif key == "tracking_rate":
                    config.tracking_rate = max(1, int(val))
            except ValueError:
                print(f"reconfig: bad value {key}={val!r}",
                      file=sys.stderr)
        return rebuild

    kf, kf_state = build_kf()
    dash = DashboardState()
    dash.params = current_params()
    if start_paused:
        dash.control("pause")
    httpd = serve(dash, port)
    print(f"dashboard: http://127.0.0.1:{httpd.server_address[1]}/",
          file=sys.stderr)

    def render_tile():
        d, t, v = (img.cpu().numpy() for img in (
            kf.render_depth_image(kf_state), kf.render_track_image(kf_state),
            kf.render_volume_image(kf_state)))
        return encode_png(compose_tile(d, t, v))

    def service_mesh_request() -> None:
        # Pipeline-thread half of the /mesh.ply handshake: a host copy of
        # the volume, taken between frames.
        if dash.mesh_request.is_set():
            dash.mesh_tsdf = (kf_state.tsdf.cpu().numpy().astype(np.float32)
                              / 32766.0)
            dash.mesh_request.clear()
            dash.mesh_ready.set()

    def mesh_ply() -> bytes:
        # HTTP-thread half: ask the pipeline thread for a snapshot, then
        # triangulate the (host) copy here.
        from slambench_tpu_torch.tools.mesh_export import (
            ply_bytes, surface_nets,
        )
        dash.mesh_ready.clear()
        dash.mesh_request.set()
        if not dash.mesh_ready.wait(timeout=60.0):
            raise RuntimeError("pipeline thread did not service the mesh "
                               "snapshot request (busy/stalled); retry")
        verts, tris = surface_nets(dash.mesh_tsdf, dim=kf.volume_dimensions)
        return ply_bytes(verts, tris)

    dash.mesh_provider = mesh_ply
    if on_serve is not None:
        on_serve(dash, httpd)

    frame = 0
    try:
        while True:
            service_mesh_request()
            mode = dash.wait_if_paused(idle_cb=service_mesh_request)
            if mode == CLOSED:
                break
            if mode == "RENDER":       # forceRender: no frame consumed
                dash.publish(frame, bool(kf_state.tracked),
                             bool(kf_state.integrated),
                             kf.get_position(kf_state), {}, render_tile())
                continue
            if dash.take_reset() or mode == "RESET":
                dash.take_reset()
                reader.restart()
                kf_state = kf.init_state()
                frame = 0
                continue
            changes = dash.take_reconfig()
            if changes:
                if apply_reconfig(changes):
                    reader.restart()
                    kf, kf_state = build_kf()
                    frame = 0
                with dash.lock:
                    dash.params = current_params()
                print(f"reconfigured: {changes}", file=sys.stderr)
                continue
            depth = reader.read_next_depth_frame()
            if depth is None:
                dash.control("pause")   # end of scene: hold for controls
                continue
            t0 = time.monotonic()
            kf_state = kf.process_frame(
                kf_state, np.ascontiguousarray(depth), frame,
                config.tracking_rate, config.integration_rate)
            pose = kf.get_position(kf_state)
            dt = time.monotonic() - t0
            tile = render_tile() if frame % every == 0 else None
            dash.publish(frame, bool(kf_state.tracked),
                         bool(kf_state.integrated), pose,
                         {"computation_s": dt,
                          "fps": 1.0 / dt if dt > 0 else 0.0,
                          "X": float(pose[0]), "Y": float(pose[1]),
                          "Z": float(pose[2])},
                         tile)
            frame += 1
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(run_dashboard())
