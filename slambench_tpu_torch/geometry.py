"""Core geometry: camera intrinsics, rigid transforms, SE(3) exp/log and
the 6x6 normal-equations solve (port of ``slambench_tpu/geometry.py``).

Same conventions as the JAX package: a ``Matrix4`` is a row-major
``[4, 4]`` float32 tensor, point/vector maps are component-first
``[3, ...]``, the twist is TooN's ``[u, w]`` (translation first), and the
solve keeps TooN ``GR_SVD::backsub``'s 1e6 condition clamp
(reference: commons.h:317-412). Matmuls run in full float32 (see
``policy.apply_precision_policy``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

_F32 = torch.float32


# (repr(values), dtype, device) -> the uploaded tensor. The key holds
# repr(values) so that values that compare equal but differ in bits or
# type (0.0 and -0.0, 1 and 1.0) get tensors of their own.
_constants: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}


def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small read-only constant tensor, uploaded once per
    ``(values, dtype, device)`` and returned from a cache after that.

    ``torch.tensor(..., device="cuda")`` is a pageable host-to-device
    copy that synchronises the host with the card; the frame step builds
    its constants here so that its loops (the ICP iterations, the
    raycast) queue device work without stalls. The tensor is shared by
    every caller: callers must not write to it.
    """
    key = (repr(values), dtype, torch.device(device))
    out = _constants.get(key)
    if out is None:
        out = _constants[key] = torch.tensor(values, dtype=dtype,
                                             device=device)
    return out


def _bottom_row(device) -> torch.Tensor:
    return constant(((0.0, 0.0, 0.0, 1.0),), _F32, torch.device(device))


def get_camera_matrix(k: torch.Tensor) -> torch.Tensor:
    """4x4 projection matrix from ``k = (fx, fy, cx, cy)``
    (reference: commons.h:343-350)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    z = torch.zeros((), dtype=_F32, device=k.device)
    o = torch.ones((), dtype=_F32, device=k.device)
    return torch.stack([
        torch.stack([fx, z, cx, z]),
        torch.stack([z, fy, cy, z]),
        torch.stack([z, z, o, z]),
        torch.stack([z, z, z, o]),
    ]).to(_F32)


def get_inverse_camera_matrix(k: torch.Tensor) -> torch.Tensor:
    """Inverse projection matrix (reference: commons.h:352-359)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    z = torch.zeros((), dtype=_F32, device=k.device)
    o = torch.ones((), dtype=_F32, device=k.device)
    return torch.stack([
        torch.stack([1.0 / fx, z, -cx / fx, z]),
        torch.stack([z, 1.0 / fy, -cy / fy, z]),
        torch.stack([z, z, o, z]),
        torch.stack([z, z, z, o]),
    ]).to(_F32)


def mat4mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small matrix product at full float32 precision (TF32 is off)."""
    return torch.matmul(a, b)


def transform(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Affine part of a Matrix4 applied to ``[3, ...]`` points
    (reference: commons.h:331-336)."""
    return torch.stack([
        m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2] + m[0, 3],
        m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2] + m[1, 3],
        m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2] + m[2, 3],
    ])


def rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Linear part of a Matrix4 applied to ``[3, ...]`` vectors
    (reference: commons.h:338-341)."""
    return torch.stack([
        m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2],
        m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2],
        m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2],
    ])


def get_translation(m: torch.Tensor) -> torch.Tensor:
    return m[:3, 3]


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid Matrix4: ``[R^T, -R^T t]``."""
    rt = m[:3, :3].T
    ti = -torch.matmul(rt, m[:3, 3])
    top = torch.cat([rt, ti[:, None]], dim=1)
    return torch.cat([top, _bottom_row(m.device)], dim=0)


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of component-first ``[3, ...]`` tensors."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def length3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(a, a))


def normalize3(a: torch.Tensor) -> torch.Tensor:
    """``v / |v|``; non-finite for zero-length input, like the
    reference's ``normalize`` (callers gate on length)."""
    return a * torch.rsqrt(dot3(a, a))


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([
        torch.stack([z, -w[2], w[1]]),
        torch.stack([w[2], z, -w[0]]),
        torch.stack([-w[1], w[0], z]),
    ])


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=_F32, device=device)


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential -> Matrix4, TooN's three-branch closed form
    (small / mid / full angle), as in the JAX package."""
    x = x.to(_F32)
    u = x[:3]
    w = x[3:]
    theta_sq = torch.dot(w, w)

    safe_theta_sq = torch.clamp(theta_sq, min=1e-12)
    safe_theta = torch.sqrt(safe_theta_sq)
    small = theta_sq < 1e-8
    mid = theta_sq < 1e-6

    a_small = 1.0 - theta_sq / 6.0
    b_small = torch.full_like(theta_sq, 0.5)
    c_mid = (1.0 / 6.0) * (1.0 - theta_sq / 20.0)
    a_mid = 1.0 - theta_sq * c_mid
    b_mid = 0.5 - 0.25 * (1.0 / 6.0) * theta_sq

    a_big = torch.sin(safe_theta) / safe_theta
    b_big = (1.0 - torch.cos(safe_theta)) / safe_theta_sq
    c_big = (1.0 - a_big) / safe_theta_sq

    A = torch.where(small, a_small, torch.where(mid, a_mid, a_big))
    B = torch.where(small, b_small, torch.where(mid, b_mid, b_big))
    C = torch.where(small, torch.full_like(theta_sq, 1.0 / 6.0),
                    torch.where(mid, c_mid, c_big))

    wxu = torch.linalg.cross(w, u)
    t_small = u + 0.5 * wxu
    t_full = u + B * wxu + C * torch.linalg.cross(w, wxu)
    t = torch.where(small, t_small, t_full)

    hw = _hat(w)
    R = _eye(3, x.device) + A * hw + B * torch.matmul(hw, hw)
    top = torch.cat([R, t[:, None]], dim=1)
    return torch.cat([top, _bottom_row(x.device)], dim=0)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm -> ``[u, w]``, inverse of :func:`se3_exp`."""
    R = T[:3, :3]
    t = T[:3, 3]
    cos_theta = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta_sq = theta * theta

    w_skew = 0.5 * torch.stack([R[2, 1] - R[1, 2],
                                R[0, 2] - R[2, 0],
                                R[1, 0] - R[0, 1]])
    small = theta < 1e-5
    sin_theta = torch.sin(theta)
    one = torch.ones_like(theta)
    scale = torch.where(small, 1.0 + theta_sq / 6.0,
                        theta / torch.where(sin_theta == 0, one, sin_theta))
    w = w_skew * scale

    hw = _hat(w)
    hw2 = torch.matmul(hw, hw)
    safe_sq = torch.clamp(theta_sq, min=1e-12)
    A = torch.sin(theta) / torch.sqrt(safe_sq)
    B = (1.0 - torch.cos(theta)) / safe_sq
    coef = torch.where(small, torch.full_like(theta, 1.0 / 12.0),
                       (1.0 - A / (2.0 * torch.where(B == 0, one, B)))
                       / safe_sq)
    Vinv = _eye(3, T.device) - 0.5 * hw + coef * hw2
    return torch.cat([torch.matmul(Vinv, t), w])


def translation_pose(t: Sequence[float], device) -> torch.Tensor:
    """Pure-translation Matrix4 (reference: kernels.h:106-109)."""
    m = _eye(4, device)
    m[:3, 3] = torch.as_tensor(t, dtype=_F32, device=device)
    return m


def make_jtj(tri: torch.Tensor) -> torch.Tensor:
    """21 upper-triangle values -> symmetric 6x6, row-major packing
    (reference: commons.h:380-395)."""
    iu = torch.triu_indices(6, 6, device=tri.device)
    C = torch.zeros((6, 6), dtype=_F32, device=tri.device)
    C = C.index_put((iu[0], iu[1]), tri.to(_F32))
    return C + torch.triu(C, 1).T


def sym_eigh6_jacobi(C: torch.Tensor, sweeps: int = 6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a symmetric 6x6 by six fixed cyclic Jacobi
    sweeps, the JAX package's ``sym_eigh6_jacobi``: the same pair order
    and rotation formula. Each rotation is applied as ``R A R^T`` and
    ``V R^T`` with an exact Givens matrix, which equals the JAX row/column
    updates up to the FMA rounding of the matmul. Returns (eigenvalues
    [6], eigenvectors [6, 6] column-major)."""
    A = C.to(_F32)
    dev = A.device
    V = _eye(6, dev)
    eye = _eye(6, dev)
    zero = torch.zeros((), dtype=_F32, device=dev)
    one = torch.ones((), dtype=_F32, device=dev)
    pairs = [(p, q) for p in range(5) for q in range(p + 1, 6)]
    # Givens entries (p,p), (q,q), (p,q), (q,p) of every pair.
    rows = constant(tuple((p, q, p, q) for p, q in pairs), torch.int64, dev)
    cols = constant(tuple((p, q, q, p) for p, q in pairs), torch.int64, dev)
    for _ in range(sweeps):
        for n, (p, q) in enumerate(pairs):
            app = A[p, p]
            aqq = A[q, q]
            apq = A[p, q]
            # Stable rotation computation; |apq| ~ 0 -> identity.
            small = torch.abs(apq) < 1e-30
            safe_apq = torch.where(small, one, apq)
            theta = 0.5 * (aqq - app) / safe_apq
            sign_t = torch.where(theta >= 0, one, -one)
            t = sign_t / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(small, zero, t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            R = eye.index_put((rows[n], cols[n]), torch.stack([c, c, -s, s]))
            A = torch.matmul(torch.matmul(R, A), R.T)
            V = torch.matmul(V, R.T)
    return torch.diagonal(A), V


def solve_normal_equations(vals: torch.Tensor) -> torch.Tensor:
    """Solve ``(J^T J) x = J^T e`` from the packed 27-vector with TooN
    GR_SVD's 1e6 condition clamp (reference: commons.h:397-404)."""
    b = vals[:6]
    C = make_jtj(vals[6:27])
    lam, V = sym_eigh6_jacobi(C)
    s = torch.abs(lam)
    smax = torch.max(s)
    ones = torch.ones_like(s)
    inv = torch.where(s * 1e6 > smax, 1.0 / torch.where(s == 0, ones, s),
                      torch.zeros_like(s))
    inv = torch.where(s == 0, torch.zeros_like(s), inv)
    return torch.matmul(V, inv * torch.matmul(V.T, b))
