"""Plain-PyTorch KinectFusion frame step: the benchmark's reference.

A straightforward reading of the reference implementation's kernels
(SLAMBench 1.x ``kfusion/src/cpp/kernels.cpp`` and ``commons.h``):
mm2meters, the 5x5 bilateral filter, the robust half-sample pyramid,
vertex and normal maps, projective ICP with the 6x6 normal equations
solved through their eigen-decomposition (TooN ``GR_SVD``'s 1e6
condition clamp), checkPose, the TSDF integrate and the two-speed
trilinear raycast. It imports nothing of the program under test and
takes nothing the program made, except where a check hands it the
program's state to start one call's frames from (``check.py``).

Storage follows the reference: the TSDF as ``value * 32766`` in int16,
the weight (at most 100) in int8, ``[Z, Y, X]``. Every per-pixel and
per-voxel quantity is computed in ``dtype``: float32, as the
configuration states, or a lower precision for the control
(``check.py``). Poses are float32 between steps; the 6x6 solve and the
SE(3) exponential run in float64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

E_DELTA = 0.1            # bilateral range sigma (m)
RADIUS = 2               # bilateral window radius
DELTA = 4.0              # bilateral spatial sigma (pixels)
DIST_THRESHOLD = 0.1     # ICP association distance (m)
NORMAL_THRESHOLD = 0.8   # ICP normal agreement (cosine)
TRACK_THRESHOLD = 0.15   # least share of tracked pixels
MAX_WEIGHT = 100.0
NEAR_PLANE = 0.4
FAR_PLANE = 4.0
INVALID = -2.0
TSDF_SCALE = 32766.0
TSDF_INV_SCALE = 0.00003051944088
RMS_BOUND = 2e-2


def camera_matrix(k: Sequence[float], device) -> torch.Tensor:
    fx, fy, cx, cy = k
    return torch.tensor([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]], dtype=torch.float64, device=device)


def rigid_inv(m: torch.Tensor) -> torch.Tensor:
    r = m[:3, :3].T
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = r
    out[:3, 3] = -r @ m[:3, 3]
    return out


def apply(m: torch.Tensor, v: torch.Tensor, translate: bool = True
          ) -> torch.Tensor:
    """``m``'s affine (or linear) part on component-first points."""
    m = m.to(v.dtype)
    out = torch.stack([m[i, 0] * v[0] + m[i, 1] * v[1] + m[i, 2] * v[2]
                       for i in range(3)])
    if translate:
        out = out + m[:3, 3].reshape(3, *([1] * (v.dim() - 1)))
    return out


def cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """float64 SE(3) exponential of the twist ``[u, w]``."""
    u, w = x[:3], x[3:]
    th2 = float(w @ w)
    th = math.sqrt(th2)
    if th2 < 1e-12:
        a, b, c = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        a = math.sin(th) / th
        b = (1.0 - math.cos(th)) / th2
        c = (1.0 - a) / th2
    hat = torch.zeros((3, 3), dtype=torch.float64, device=x.device)
    hat[0, 1], hat[0, 2], hat[1, 2] = -w[2], w[1], -w[0]
    hat[1, 0], hat[2, 0], hat[2, 1] = w[2], -w[1], w[0]
    eye = torch.eye(3, dtype=torch.float64, device=x.device)
    out = torch.eye(4, dtype=torch.float64, device=x.device)
    out[:3, :3] = eye + a * hat + b * hat @ hat
    out[:3, 3] = (eye + b * hat + c * hat @ hat) @ u
    return out


class Reference:
    """One deployment's frame step. ``setting`` is a configuration
    file's dict; the state is a dict of tensors on ``device``."""

    def __init__(self, setting: dict, device, dtype=torch.float32):
        self.dev = torch.device(device)
        self.dt = dtype
        iw, ih = setting["input_size"]
        self.ratio = int(setting["compute_size_ratio"])
        self.W, self.H = iw // self.ratio, ih // self.ratio
        self.res = tuple(int(v) for v in setting["volume_resolution"])
        self.dim = tuple(float(d) for d in setting["volume_size"])
        self.k = [c / self.ratio for c in setting["camera"]]
        self.init = [f * d for f, d in zip(setting["init_pose"], self.dim)]
        self.pyramid = tuple(int(i) for i in setting["pyramid"])
        self.mu = float(setting["mu"])
        self.icp_threshold = float(setting["icp_threshold"])
        self.step = min(self.dim) / max(self.res)
        self.large_step = 0.75 * self.mu
        g = [math.exp(-(i * i) / (2.0 * DELTA * DELTA))
             for i in range(-RADIUS, RADIUS + 1)]
        self.gauss = torch.tensor(g, dtype=torch.float32)

    # ---------------------------- state ---------------------------- #

    def init_state(self) -> dict:
        rx, ry, rz = self.res
        pose = torch.eye(4, dtype=torch.float32, device=self.dev)
        pose[:3, 3] = torch.tensor(self.init, dtype=torch.float32)
        z = torch.zeros((3, self.H, self.W), dtype=self.dt, device=self.dev)
        return {"tsdf": torch.full((rz, ry, rx), 32766, dtype=torch.int16,
                                   device=self.dev),
                "weight": torch.zeros((rz, ry, rx), dtype=torch.int8,
                                      device=self.dev),
                "pose": pose, "raycast_pose": pose.clone(),
                "ref_vertex": z, "ref_normal": z.clone(),
                "float_depth": z[0].clone(), "scaled_depth0": z[0].clone(),
                "tracked": False}

    def from_program(self, state) -> dict:
        """The start of a check: copies of the leaves of the program's
        state that the next frame reads."""
        def f(t):
            return t.detach().to(self.dev).clone()
        return {"tsdf": f(state.tsdf), "weight": f(state.weight),
                "pose": f(state.pose).float(),
                "raycast_pose": f(state.raycast_pose).float(),
                "ref_vertex": f(state.ref_vertex).to(self.dt),
                "ref_normal": f(state.ref_normal).to(self.dt),
                "float_depth": f(state.float_depth).to(self.dt),
                "scaled_depth0": f(state.scaled_depth0).to(self.dt),
                "tracked": bool(state.tracked)}

    # ------------------------- preprocessing ------------------------ #

    def mm2meters(self, mm: torch.Tensor) -> torch.Tensor:
        r = self.ratio
        return mm[::r, ::r].to(torch.float64).div(1000.0).to(self.dt)

    def bilateral(self, d: torch.Tensor) -> torch.Tensor:
        H, W = d.shape
        ys = torch.arange(H, device=self.dev)
        xs = torch.arange(W, device=self.dev)
        t = torch.zeros_like(d)
        s = torch.zeros_like(d)
        for j in range(-RADIUS, RADIUS + 1):
            yi = ys + j
            yi = torch.where((yi < 0) | (yi > H - 1), H - 1, yi)
            for i in range(-RADIUS, RADIUS + 1):
                xi = xs + i
                xi = torch.where((xi < 0) | (xi > W - 1), W - 1, xi)
                cur = d[yi][:, xi]
                gg = float(self.gauss[i + RADIUS] * self.gauss[j + RADIUS])
                fac = gg * torch.exp(-((cur - d) ** 2)
                                     / (2.0 * E_DELTA * E_DELTA))
                ok = cur > 0
                t = t + torch.where(ok, fac * cur, 0.0)
                s = s + torch.where(ok, fac, 0.0)
        return torch.where(d == 0, 0.0, t / s).to(self.dt)

    def half_sample(self, d: torch.Tensor) -> torch.Tensor:
        H, W = d.shape
        oh, ow = H // 2, W // 2
        c = d[0:2 * oh:2, 0:2 * ow:2]
        t = torch.zeros_like(c)
        s = torch.zeros_like(c)
        for i in (0, 1):
            for j in (0, 1):
                yi = torch.clamp(2 * torch.arange(oh, device=self.dev) + i,
                                 0, 2 * oh - 1)
                xi = torch.clamp(2 * torch.arange(ow, device=self.dev) + j,
                                 0, 2 * ow - 1)
                cur = d[yi][:, xi]
                ok = torch.abs(cur - c) < 3 * E_DELTA
                t = t + torch.where(ok, cur, 0.0)
                s = s + ok.to(self.dt)
        return (t / s).to(self.dt)

    def vertex_map(self, d: torch.Tensor, level: int) -> torch.Tensor:
        fx, fy, cx, cy = (c / (1 << level) for c in self.k)
        H, W = d.shape
        x = torch.arange(W, device=self.dev, dtype=self.dt)[None, :]
        y = torch.arange(H, device=self.dev, dtype=self.dt)[:, None]
        ray = torch.stack([((x - cx) / fx).expand(H, W),
                           ((y - cy) / fy).expand(H, W),
                           torch.ones((H, W), dtype=self.dt,
                                      device=self.dev)])
        return torch.where(d[None] > 0, d[None] * ray, 0.0).to(self.dt)

    def normal_map(self, v: torch.Tensor) -> torch.Tensor:
        left = torch.cat([v[:, :, :1], v[:, :, :-1]], 2)
        right = torch.cat([v[:, :, 1:], v[:, :, -1:]], 2)
        up = torch.cat([v[:, :1], v[:, :-1]], 1)
        down = torch.cat([v[:, 1:], v[:, -1:]], 1)
        bad = (left[2] == 0) | (right[2] == 0) | (up[2] == 0) \
            | (down[2] == 0)
        n = cross(down - up, right - left)
        n = n / torch.sqrt(dot(n, n))
        marker = torch.zeros_like(n)
        marker[0] = INVALID
        return torch.where(bad[None], marker, n).to(self.dt)

    # ---------------------------- tracking -------------------------- #

    def reduction(self, vert, norm, ref_v, ref_n, pose, view):
        """(err^2 sum, JTe [6], JTJ [6, 6], count) in float64."""
        _, H, W = ref_v.shape
        pv = apply(pose, vert)
        pp = apply(view, pv)
        px = pp[0] / pp[2] + 0.5
        py = pp[1] / pp[2] + 0.5
        inb = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        u = torch.clamp(torch.nan_to_num(px.float(), 0.0), 0, W - 1).long()
        v = torch.clamp(torch.nan_to_num(py.float(), 0.0), 0, H - 1).long()
        flat = v * W + u
        rn = ref_n.reshape(3, -1)[:, flat]
        rv = ref_v.reshape(3, -1)[:, flat]
        diff = rv - pv
        pn = apply(pose, norm, translate=False)
        # The reference's early-continue tests, NaN passing as there.
        good = (norm[0] != INVALID) & inb & (rn[0] != INVALID) \
            & ~(torch.sqrt(dot(diff, diff)) > DIST_THRESHOLD) \
            & ~(dot(pn, rn) < NORMAL_THRESHOLD)
        err = dot(rn, diff)
        J = torch.cat([rn, cross(pv, rn)], 0)
        A = torch.cat([err[None], J], 0).reshape(7, -1)
        A = A * good.reshape(1, -1).to(A.dtype)
        G = (A @ A.T).to(torch.float64)
        return G[0, 0], G[0, 1:], G[1:, 1:], float(good.sum())

    def solve(self, b: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
        lam, V = torch.linalg.eigh(C)
        s = torch.abs(lam)
        smax = float(s.max())
        inv = torch.where((s * 1e6 > smax) & (s > 0),
                          1.0 / torch.where(s > 0, s, 1.0), 0.0)
        return V @ (inv * (V.T @ b))

    def tracking(self, st: dict) -> dict:
        sd0 = st["scaled_depth0"]
        pyr = [sd0]
        for _ in range(1, len(self.pyramid)):
            pyr.append(self.half_sample(pyr[-1]))
        verts = [self.vertex_map(d, i) for i, d in enumerate(pyr)]
        norms = [self.normal_map(v) for v in verts]
        K = camera_matrix(self.k, self.dev)
        view = K @ rigid_inv(st["raycast_pose"].double())
        old = st["pose"]
        pose = old.double()
        last = None
        for level in reversed(range(len(self.pyramid))):
            for _ in range(self.pyramid[level]):
                e2, b, C, n = self.reduction(
                    verts[level], norms[level], st["ref_vertex"],
                    st["ref_normal"], pose.float(), view)
                x = self.solve(b, C)
                pose = (se3_exp(x) @ pose).float().double()
                last = (e2, n)
                if float(torch.linalg.vector_norm(x)) < self.icp_threshold:
                    break
        e2, n = last
        rms = math.sqrt(float(e2) / n) if n > 0 else math.nan
        bad = (rms > RMS_BOUND) or (n / (self.H * self.W) < TRACK_THRESHOLD)
        out = dict(st)
        out["pose"] = old.clone() if bad else pose.float()
        out["tracked"] = not bad
        return out

    # --------------------------- integration ------------------------ #

    def _voxels(self, pose: torch.Tensor, depth: torch.Tensor,
                slab: int):
        """Per z-slab of the volume: (slice, update mask, sdf) of a
        frame's integrate from camera ``pose`` with metre ``depth``."""
        rx, ry, rz = self.res
        dx, dy, dz = self.dim
        M = rigid_inv(pose.double()).tolist()
        fx, fy, cx, cy = self.k
        H, W = depth.shape
        X = ((torch.arange(rx, device=self.dev, dtype=self.dt) + 0.5)
             * (dx / rx))[None, None, :]
        Y = ((torch.arange(ry, device=self.dev, dtype=self.dt) + 0.5)
             * (dy / ry))[None, :, None]
        for z0 in range(0, rz, slab):
            Z = ((torch.arange(z0, min(z0 + slab, rz), device=self.dev,
                               dtype=self.dt) + 0.5)
                 * (dz / rz))[:, None, None]
            p = [m[0] * X + m[1] * Y + m[2] * Z + m[3] for m in M[:3]]
            pz = p[2]
            u = fx * p[0] / pz + cx + 0.5
            v = fy * p[1] / pz + cy + 0.5
            ok = (pz >= 1e-4) & (u >= 0) & (u <= W - 1) & (v >= 0) \
                & (v <= H - 1)
            ui = torch.clamp(torch.nan_to_num(u.float(), 0.0), 0, W - 1) \
                .long()
            vi = torch.clamp(torch.nan_to_num(v.float(), 0.0), 0, H - 1) \
                .long()
            d = depth.reshape(-1)[vi * W + ui].to(self.dt)
            diff = (d - pz) * torch.sqrt(1.0 + (p[0] / pz) ** 2
                                         + (p[1] / pz) ** 2)
            ok = ok & (d != 0) & (diff > -self.mu)
            yield (slice(z0, z0 + Z.shape[0]), ok,
                   torch.clamp(diff / self.mu, max=1.0))

    def integrate(self, st: dict, slab: int = 16) -> dict:
        tsdf, weight = st["tsdf"].clone(), st["weight"].clone()
        for sl, ok, sdf in self._voxels(st["pose"], st["float_depth"],
                                        slab):
            w = weight[sl].to(self.dt)
            val = tsdf[sl].to(self.dt) * TSDF_INV_SCALE
            new = torch.clamp((w * val + sdf) / (w + 1.0), -1.0, 1.0)
            tsdf[sl] = torch.where(ok, (new.float() * TSDF_SCALE)
                                   .to(torch.int16), tsdf[sl])
            weight[sl] = torch.where(
                ok, torch.clamp(w + 1.0, max=MAX_WEIGHT).to(torch.int8),
                weight[sl])
        out = dict(st)
        out["tsdf"], out["weight"] = tsdf, weight
        return out

    def updated_voxels(self, pose: torch.Tensor, depth: torch.Tensor,
                       slab: int = 16) -> int:
        """How many voxels a frame's integrate updates: the work that the
        inputs need (``stats.integrate_bytes``)."""
        return sum(int(ok.sum()) for _, ok, _ in
                   self._voxels(pose, depth.to(self.dt), slab))

    # ---------------------------- raycast --------------------------- #

    def _scaled(self, pos):
        rx, ry, rz = self.res
        dx, dy, dz = self.dim
        sc = torch.stack([pos[0] * (rx / dx), pos[1] * (ry / dy),
                          pos[2] * (rz / dz)]) - 0.5
        base = torch.floor(sc)
        return base.long(), (sc - base).to(self.dt)

    def _vs(self, tsdf, x, y, z):
        rz, ry, rx = tsdf.shape
        x = torch.clamp(x, 0, rx - 1)
        y = torch.clamp(y, 0, ry - 1)
        z = torch.clamp(z, 0, rz - 1)
        return tsdf.reshape(-1)[(z * ry + y) * rx + x].to(self.dt)

    def interp(self, tsdf, pos):
        b, f = self._scaled(pos)
        bx, by, bz = b
        fx, fy, fz = f

        def c(i, j, k):
            return self._vs(tsdf, bx + i, by + j, bz + k)
        v = (((c(0, 0, 0) * (1 - fx) + c(1, 0, 0) * fx) * (1 - fy)
              + (c(0, 1, 0) * (1 - fx) + c(1, 1, 0) * fx) * fy) * (1 - fz)
             + ((c(0, 0, 1) * (1 - fx) + c(1, 0, 1) * fx) * (1 - fy)
                + (c(0, 1, 1) * (1 - fx) + c(1, 1, 1) * fx) * fy) * fz)
        return v * TSDF_INV_SCALE

    def grad(self, tsdf, pos):
        b, f = self._scaled(pos)
        fx, fy, fz = f
        out = []
        for axis in range(3):
            def diff(i, j, k):
                o = [i, j, k]
                hi, lo = list(o), list(o)
                hi[axis] += 1
                lo[axis] -= 1
                return (self._vs(tsdf, b[0] + hi[0], b[1] + hi[1],
                                 b[2] + hi[2])
                        - self._vs(tsdf, b[0] + lo[0], b[1] + lo[1],
                                   b[2] + lo[2]))
            out.append(
                ((diff(0, 0, 0) * (1 - fx) + diff(1, 0, 0) * fx) * (1 - fy)
                 + (diff(0, 1, 0) * (1 - fx) + diff(1, 1, 0) * fx) * fy)
                * (1 - fz)
                + ((diff(0, 0, 1) * (1 - fx) + diff(1, 0, 1) * fx) * (1 - fy)
                   + (diff(0, 1, 1) * (1 - fx) + diff(1, 1, 1) * fx) * fy)
                * fz)
        scale = [d / r * 0.5 * TSDF_INV_SCALE
                 for d, r in zip(self.dim, self.res)]
        return torch.stack([g * s for g, s in zip(out, scale)])

    def raycast(self, st: dict, check_every: int = 16) -> dict:
        tsdf = st["tsdf"]
        H, W = self.H, self.W
        view = st["pose"].double() @ torch.linalg.inv(
            camera_matrix(self.k, self.dev))
        o = view[:3, 3].to(self.dt).reshape(3, 1, 1)
        x = torch.arange(W, device=self.dev, dtype=torch.float64)[None, :]
        y = torch.arange(H, device=self.dev, dtype=torch.float64)[:, None]
        dirs = torch.stack([(view[i, 0] * x + view[i, 1] * y + view[i, 2])
                            .expand(H, W) for i in range(3)]).to(self.dt)
        dim = torch.tensor(self.dim, dtype=self.dt,
                           device=self.dev).reshape(3, 1, 1)
        inv = 1.0 / dirs
        tb = -inv * o
        tt = inv * (dim - o)
        tmin, tmax = torch.minimum(tt, tb), torch.maximum(tt, tb)
        tnear = torch.clamp(torch.maximum(torch.maximum(tmin[0], tmin[1]),
                                          torch.maximum(tmin[0], tmin[2])),
                            min=NEAR_PLANE)
        tfar = torch.clamp(torch.minimum(torch.minimum(tmax[0], tmax[1]),
                                         torch.minimum(tmax[0], tmax[2])),
                           max=FAR_PLANE)
        t = tnear.clone()
        f_t = self.interp(tsdf, o + dirs * t[None])
        live = (tnear < tfar) & (f_t > 0)
        stepsize = torch.full_like(t, self.large_step)
        t_hit = torch.zeros_like(t)
        max_iters = 4 * int((FAR_PLANE - NEAR_PLANE) / self.step) + 16
        for it in range(max_iters):
            if it % check_every == 0 and not bool(live.any()):
                break
            f_tt = self.interp(tsdf, o + dirs * t[None])
            hit = live & (f_tt < 0)
            # The crossing by linear interpolation over the step that
            # found it (kernels.cpp:716-719).
            t_hit = torch.where(hit, t + stepsize * f_tt / (f_t - f_tt),
                                t_hit)
            cont = live & ~hit
            new_step = torch.where(f_tt < 0.8, self.step, stepsize)
            stepsize = torch.where(cont, new_step, stepsize)
            f_t = torch.where(cont, f_tt, f_t)
            t = torch.where(cont, t + new_step, t)
            live = cont & (t < tfar)
        got = t_hit > 0
        pos = o + dirs * t_hit[None]
        g = self.grad(tsdf, pos)
        glen = torch.sqrt(dot(g, g))
        marker = torch.zeros_like(g)
        marker[0] = INVALID
        out = dict(st)
        out["ref_vertex"] = torch.where(got[None], pos, 0.0).to(self.dt)
        out["ref_normal"] = torch.where((got & (glen != 0))[None],
                                        g / glen, marker).to(self.dt)
        out["raycast_pose"] = st["pose"].clone()
        return out

    # ------------------------------ step ---------------------------- #

    def step_frame(self, st: dict, depth_mm: torch.Tensor, frame: int
                   ) -> dict:
        """One frame with the ``-r 1`` gates of stream frame ``frame``:
        tracking always, integrate when tracked or at frames 0-3, raycast
        past frame 2."""
        st = dict(st)
        st["float_depth"] = self.mm2meters(depth_mm.to(self.dev))
        st["scaled_depth0"] = self.bilateral(st["float_depth"])
        st = self.tracking(st)
        if st["tracked"] or frame <= 3:
            st = self.integrate(st)
        if frame > 2:
            st = self.raycast(st)
        return st


def run_frames(ref: Reference, st: Optional[dict], depths: torch.Tensor,
               first: int) -> Tuple[dict, list]:
    """Frames ``depths [n, H, W]`` (stream frames ``first``...) from
    ``st`` (a fresh state when None): the last state and each frame's
    camera position as float64 numpy rows."""
    st = ref.init_state() if st is None else st
    rows = []
    for i in range(depths.shape[0]):
        st = ref.step_frame(st, depths[i], first + i)
        rows.append(st["pose"][:3, 3].double().cpu().numpy())
    return st, rows
