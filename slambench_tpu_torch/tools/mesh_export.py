"""TSDF -> triangle-mesh export (naive surface nets); a copy of
``slambench_tpu/tools/mesh_export.py`` that reads the port's
``KFusion.dump_volume`` output and checkpoints.

Beyond-reference capability: the reference can only dump the raw TSDF
shorts (`-d`, reference: kfusion/src/cpp/kernels.cpp:1006-1030 — the
byte format `pipeline.dump_volume` reproduces) and leaves surfacing to
the user. This tool turns that dump (or a checkpoint) into a mesh:

* **naive surface nets** rather than marching cubes: one vertex per
  sign-changing cell placed at the mean of its edge zero-crossings,
  quads emitted per sign-changing grid edge — no 256-entry case
  tables, no sliver triangles, and the whole thing vectorizes over
  cells as flat numpy, which is the same design instinct as the
  device pipeline (bulk array ops, no per-cell control flow).
* Host-side by design: meshing is an offline export (dynamic output
  size), not a per-frame device op — it reads the *dumped* volume, so
  it runs anywhere without torch.

Usage:
  python -m slambench_tpu_torch.tools.mesh_export vol.dump \
      --resolution 256 --dim 4.8 -o mesh.ply   # or mesh.obj
  python -m slambench_tpu_torch.tools.mesh_export ckpt.npz -o mesh.ply

The dump stores only the value shorts (x-fastest, [Z, Y, X]); unseen
space holds +1.0 (init_volume), so the zero crossing is exactly the
raycast's surface definition (ops/raycast_fast.py).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# Cell-corner offsets in (z, y, x), and the 12 cube edges as corner
# index pairs (each edge spans exactly one axis).
_CORNERS = np.array([(z, y, x) for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)], np.int64)           # [8, 3]
_EDGES = np.array([(a, b) for a in range(8) for b in range(8)
                   if a < b and bin(a ^ b).count("1") == 1], np.int64)


def load_tsdf(path: str, resolution: int | None) -> np.ndarray:
    """Float TSDF [Z, Y, X] from a reference-format dump (int16 shorts,
    value*32766) or a checkpoint .npz (utils/checkpoint.py)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "tsdf" not in z:
                raise SystemExit(
                    f"{path}: no 'tsdf' array in archive "
                    f"(found: {', '.join(sorted(z.files))}) — expected a "
                    "utils/checkpoint.py checkpoint")
            raw = z["tsdf"]
        return raw.astype(np.float32) / 32766.0
    raw = np.fromfile(path, dtype="<i2")
    if resolution is None:
        resolution = round(raw.size ** (1 / 3))
    n = resolution
    if raw.size != n ** 3:
        raise SystemExit(f"dump holds {raw.size} shorts; "
                         f"--resolution {n} needs {n ** 3}")
    return raw.reshape(n, n, n).astype(np.float32) / 32766.0


def surface_nets(vol: np.ndarray, dim=(1.0, 1.0, 1.0)):
    """Mesh the zero crossing of ``vol`` [Z, Y, X].

    Returns (vertices [Nv, 3] world xyz, triangles [Nt, 3] int32).
    """
    nz, ny, nx = vol.shape
    inside = vol < 0.0

    # --- active cells: any corner differs from corner 0 --------------- #
    c0 = inside[:-1, :-1, :-1]
    active = np.zeros_like(c0)
    for dz, dy, dx in _CORNERS[1:]:
        active |= c0 ^ inside[dz:nz - 1 + dz, dy:ny - 1 + dy,
                              dx:nx - 1 + dx]
    cz, cy, cx = np.nonzero(active)
    n_cells = cz.size
    if n_cells == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Corner values per active cell: [n_cells, 8]
    vals = np.stack([vol[cz + dz, cy + dy, cx + dx]
                     for dz, dy, dx in _CORNERS], axis=1)

    # --- vertex = mean of edge zero-crossings -------------------------- #
    pos_sum = np.zeros((n_cells, 3), np.float64)
    cross_n = np.zeros((n_cells,), np.float64)
    for a, b in _EDGES:
        va, vb = vals[:, a], vals[:, b]
        m = (va < 0) != (vb < 0)
        # linear zero along the edge; denominator never 0 where m holds
        t = np.where(m, va / np.where(m, va - vb, 1.0), 0.0)
        p = _CORNERS[a] + t[:, None] * (_CORNERS[b] - _CORNERS[a])
        pos_sum += np.where(m[:, None], p, 0.0)
        cross_n += m
    # cell-local (z,y,x) -> global voxel coords
    verts_zyx = np.stack([cz, cy, cx], 1) + pos_sum / cross_n[:, None]

    # Voxel -> world: volume.py's voxel_centers convention
    # (pos = (i + 0.5) * dim / res), world axes ordered x, y, z.
    scale = np.array([dim[2] / nz, dim[1] / ny, dim[0] / nx])
    verts = ((verts_zyx + 0.5) * scale)[:, ::-1].astype(np.float32)

    # --- quads: one per sign-changing grid edge ------------------------ #
    vid = np.full(c0.shape, -1, np.int64)
    vid[cz, cy, cx] = np.arange(n_cells)

    tris = []
    # axis = the edge direction; the quad connects the 4 cells around it.
    for axis in range(3):  # 0=z, 1=y, 2=x
        u, w = [a for a in range(3) if a != axis]
        # (axis, u, w) is an odd permutation of (0,1,2) for axis=1 —
        # the quad's cyclic order flips handedness there.
        odd = axis == 1
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, -1)
        sl_hi[axis] = slice(1, None)
        flip = inside[tuple(sl_lo)] & ~inside[tuple(sl_hi)]   # exit edges
        entr = ~inside[tuple(sl_lo)] & inside[tuple(sl_hi)]   # entry edges
        for mask, wind in ((flip, True), (entr, False)):
            ez, ey, ex = np.nonzero(mask)
            e = np.stack([ez, ey, ex], 1)
            # interior edges only: all 4 adjacent cells must exist
            keep = (e[:, u] > 0) & (e[:, w] > 0) \
                & (e[:, u] < vid.shape[u]) & (e[:, w] < vid.shape[w]) \
                & (e[:, axis] < vid.shape[axis])
            e = e[keep]
            if not e.size:
                continue
            quad = []
            for du, dw in ((1, 1), (0, 1), (0, 0), (1, 0)):
                c = e.copy()
                c[:, u] -= du
                c[:, w] -= dw
                quad.append(vid[c[:, 0], c[:, 1], c[:, 2]])
            q = np.stack(quad, 1)            # [n, 4] vertex ids
            q = q[(q >= 0).all(1)]
            if wind != odd:   # orient outward: exit edges XOR odd axis
                q = q[:, ::-1]
            tris.append(q[:, (0, 1, 2)])
            tris.append(q[:, (0, 2, 3)])
    tris = np.concatenate(tris, 0).astype(np.int32) if tris \
        else np.zeros((0, 3), np.int32)
    return verts, tris


def ply_bytes(verts: np.ndarray, tris: np.ndarray) -> bytes:
    head = (f"ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rec = np.empty(len(tris), dtype=[("n", "u1"), ("v", "<i4", 3)])
    rec["n"] = 3
    rec["v"] = tris
    return head + verts.astype("<f4").tobytes() + rec.tobytes()


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(ply_bytes(verts, tris))


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write("v %.6f %.6f %.6f\n" % tuple(v))
        for t in tris + 1:
            f.write("f %d %d %d\n" % tuple(t))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="TSDF dump (-d output) or checkpoint .npz")
    ap.add_argument("-o", "--output", required=True, help=".ply or .obj")
    ap.add_argument("--resolution", type=int, default=None,
                    help="dump-side voxels per axis (default: cube root)")
    ap.add_argument("--dim", type=float, default=2.0,
                    help="volume metres per axis (reference default 2.0)")
    args = ap.parse_args(argv)

    vol = load_tsdf(args.input, args.resolution)
    verts, tris = surface_nets(vol, dim=(args.dim,) * 3)
    ext = os.path.splitext(args.output)[1].lower()
    if ext == ".obj":
        write_obj(args.output, verts, tris)
    else:
        write_ply(args.output, verts, tris)
    print(f"{args.output}: {len(verts)} vertices, {len(tris)} triangles",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
