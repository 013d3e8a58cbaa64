"""Bundle adjustment with Schur-complement landmark marginalization,
sparse formulation (port of ``slambench_tpu/models/ba.py``).

Problem form: camera-to-world poses ``T_i``, world landmarks ``X_l``,
and 3-D observations ``z_il`` of landmark ``l`` in camera ``i``'s frame
(back-projected depth pixels). Residual ``r = T_i^-1 X_l - z`` with the
analytic Jacobians ``J_cam = [-I | hat(p)]`` (right perturbation) and
``J_lm = R_i^T``.

One Gauss-Newton step, O(K) in the observation count K (no ``[N, M]``
or ``[N, N]`` block is formed):

  1. per-observation products: the 6x6 / 3x3 diagonal blocks and the
     gradient terms are summed per camera and per landmark with
     ``index_add_``; the 6x3 cross blocks stay per observation;
  2. matrix-free Schur solve: ``S dc = -b_red`` with ``S = blkdiag(Hcc)
     - Hcl Hll^-1 Hlc`` by preconditioned conjugate gradients, each
     ``S @ x`` two scatter passes over the observations, the
     preconditioner the inverse of ``S``'s diagonal blocks without the
     Schur term; a fixed number of steps with eps-guarded step sizes and
     no host read, so a converged residual makes the rest inert;
  3. landmarks back-substitute.

Zero-weight observations are inert padding. With ``group`` (a
``parallel/mesh.py`` ``Mesh``; JAX's ``axis_name``) each rank
holds a share of the observations and the per-camera and per-landmark
sums, the residual and every scatter pass back to cameras or landmarks
are all-reduced, where JAX psums them; the ranks then step alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slambench_tpu_torch.geometry import se3_exp

_F32 = torch.float32
_exps = torch.func.vmap(se3_exp)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew matrices of ``[..., 3]`` vectors -> ``[..., 3, 3]``."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``Mesh.psum``), or
    ``x`` itself without one."""
    return x if group is None else group.psum(x, "ba_psum")


def bundle_adjust(poses: torch.Tensor,        # [N, 4, 4]
                  landmarks: torch.Tensor,    # [M, 3]
                  obs_cam: torch.Tensor,      # [K] int
                  obs_lm: torch.Tensor,       # [K] int
                  obs_z: torch.Tensor,        # [K, 3] camera-frame points
                  obs_w: torch.Tensor,        # [K] weights (0 = padding)
                  n_iters: int = 5,
                  damping: float = 1e-4,
                  prior_weight: float = 1e6,
                  n_cg: int = 0,
                  group=None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (poses, landmarks, the weighted squared residual of the
    last iteration, before its update).

    ``n_cg``: conjugate-gradient steps for the reduced camera system
    (0 = ``min(6N, 64)``; with the block-Jacobi preconditioner the
    system converges far before the 6N exact-arithmetic bound).
    """
    N = poses.shape[0]
    M = landmarks.shape[0]
    dev = poses.device
    if n_cg <= 0:
        n_cg = min(6 * N, 64)
    obs_cam = obs_cam.to(torch.int64)
    obs_lm = obs_lm.to(torch.int64)
    obs_w = obs_w.to(_F32)
    K = obs_cam.shape[0]
    eye3 = torch.eye(3, dtype=_F32, device=dev)
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    r2 = torch.zeros((), dtype=_F32, device=dev)

    for _ in range(n_iters):
        Ti = poses[obs_cam]                              # [K, 4, 4]
        Rt = Ti[:, :3, :3].transpose(1, 2)               # [K, 3, 3] R^T
        t = Ti[:, :3, 3]
        X = landmarks[obs_lm]                            # [K, 3]
        p = torch.einsum("kab,kb->ka", Rt, X - t)
        r = (p - obs_z) * obs_w[:, None]

        # J_cam = [-I | hat(p)]  (3x6);  J_lm = R^T  (3x3).
        Jc = torch.cat([-eye3.expand(K, 3, 3), _hat(p)], dim=2)  # [K, 3, 6]
        Jl = Rt
        w = obs_w[:, None, None]

        Hcc_k = w * torch.einsum("kai,kaj->kij", Jc, Jc)
        Hll_k = w * torch.einsum("kai,kaj->kij", Jl, Jl)
        # Sparse cross blocks: one [6, 3] block per observation.
        Hcl_k = w * torch.einsum("kai,kaj->kij", Jc, Jl)
        bc_k = torch.einsum("kai,ka->ki", Jc, r)
        bl_k = torch.einsum("kai,ka->ki", Jl, r)

        Hcc = _psum(_segment_sum(Hcc_k, obs_cam, N), group)   # [N, 6, 6]
        Hll = _psum(_segment_sum(Hll_k, obs_lm, M), group)    # [M, 3, 3]
        bc = _psum(_segment_sum(bc_k, obs_cam, N), group)     # [N, 6]
        bl = _psum(_segment_sum(bl_k, obs_lm, M), group)      # [M, 3]
        r2 = _psum(torch.sum(r * r), group)

        # Landmark marginalization (Schur), matrix-free.
        Hll_inv = torch.linalg.inv(Hll + damping * eye3)  # [M, 3, 3]

        def S_mv(x):
            # y_l = sum_k Hcl_k^T x_{cam_k}  (scatter to landmarks)
            y = _psum(_segment_sum(
                torch.einsum("kab,ka->kb", Hcl_k, x[obs_cam]), obs_lm, M),
                group)                                   # [M, 3]
            z = torch.einsum("mbc,mc->mb", Hll_inv, y)
            # w_i = sum_k Hcl_k z_{lm_k}  (gather back to cameras)
            wv = _psum(_segment_sum(
                torch.einsum("kab,kb->ka", Hcl_k, z[obs_lm]), obs_cam, N),
                group)                                   # [N, 6]
            Sx = torch.einsum("nab,nb->na", Hcc, x) - wv
            Sx = Sx + damping * x
            return torch.cat([Sx[:1] + prior_weight * x[:1], Sx[1:]])

        # Reduced gradient: b_red = bc - Hcl Hll^-1 bl.
        zb = torch.einsum("mbc,mc->mb", Hll_inv, bl)
        b_red = bc - _psum(_segment_sum(
            torch.einsum("kab,kb->ka", Hcl_k, zb[obs_lm]), obs_cam, N), group)

        # Block-Jacobi preconditioner: inverse of S's diagonal blocks
        # without the Schur term (Hcc + damping + prior).
        P_blk = Hcc + damping * eye6
        P_blk[0] = P_blk[0] + prior_weight * eye6
        P_inv = torch.linalg.inv(P_blk)                  # [N, 6, 6]

        def prec(x):
            return torch.einsum("nab,nb->na", P_inv, x)

        # Preconditioned CG on S dc = -b_red, a fixed number of steps.
        b = -b_red
        x = torch.zeros_like(b)
        rr = b
        z = prec(rr)
        pk = z
        rz = torch.sum(rr * z)
        for _ in range(n_cg):
            Sp = S_mv(pk)
            alpha = rz / torch.clamp(torch.sum(pk * Sp), min=1e-30)
            x = x + alpha * pk
            rr = rr - alpha * Sp
            z = prec(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            pk = z + beta * pk
            rz = rz_new
        dc = x

        # Back-substitute landmarks: dl = Hll^-1 (-bl - Hlc dc).
        Hlc_dc = _psum(_segment_sum(
            torch.einsum("kab,ka->kb", Hcl_k, dc[obs_cam]), obs_lm, M), group)
        dl = torch.einsum("mbc,mc->mb", Hll_inv, -bl - Hlc_dc)

        poses = torch.matmul(poses, _exps(dc))
        landmarks = landmarks + dl
    return poses, landmarks, r2


def make_observations(poses, landmarks, noise=0.0, rng=None):
    """Test helper: perfect (optionally noisy) camera-frame observations
    of every landmark from every pose."""
    N = len(poses)
    M = len(landmarks)
    cam, lm, z = [], [], []
    for i in range(N):
        Ti = np.linalg.inv(poses[i])
        for l in range(M):
            p = Ti[:3, :3] @ landmarks[l] + Ti[:3, 3]
            if noise and rng is not None:
                p = p + noise * rng.normal(size=3)
            cam.append(i)
            lm.append(l)
            z.append(p)
    return (np.asarray(cam, np.int32), np.asarray(lm, np.int32),
            np.asarray(z, np.float32),
            np.ones(len(cam), np.float32))
