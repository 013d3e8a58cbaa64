"""Port parity for the host utilities: the epsilon comparators
(``utils/compare.py``), the debug dumps (``utils/dump.py``), the TUM
trajectory files and ATE (``eval/trajectory.py``), the reference-format
volume dump of ``KFusion.dump_volume`` and the surface-nets mesh export
(``tools/mesh_export.py``) from a port dump, each against the JAX
package (test_utils.py, test_dump_volume.py, test_mesh_export.py)."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.eval import trajectory as jtraj  # noqa: E402
from slambench_tpu.geometry import se3_exp as j_se3_exp  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.tools import mesh_export as jmesh  # noqa: E402
from slambench_tpu.utils import compare as jcompare  # noqa: E402
from slambench_tpu.utils import dump as jdump  # noqa: E402

from slambench_tpu_torch.eval import trajectory as ttraj  # noqa: E402
from slambench_tpu_torch.geometry import se3_exp  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402
from slambench_tpu_torch.tools import mesh_export as tmesh  # noqa: E402
from slambench_tpu_torch.utils import compare as tcompare  # noqa: E402
from slambench_tpu_torch.utils import dump as tdump  # noqa: E402
from slambench_tpu_torch.utils.checkpoint import save_state  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KF_ARGS = ((32, 24), (8, 8, 8), (2.0,) * 3, (1.0, 1.0, 0.0), (2, 2),
           (30.0, 30.0, 16.0, 12.0))


def _comparisons(mod, out):
    a = np.zeros(10, np.float32)
    b = a.copy()
    b[3] = 1.0
    l = np.zeros((3, 4), np.float32)
    r = np.zeros((3, 4), np.float32)
    r[0, 1] = l[0, 1] = -2.0
    l[1, 1] = 9.0       # differing y under an invalid reference normal
    l[2, 3] = 0.5       # differing z under a valid one
    d1 = {"result": np.ones((2, 2), np.int32),
          "error": np.zeros((2, 2), np.float32)}
    d2 = {"result": np.ones((2, 2), np.int32),
          "error": np.zeros((2, 2), np.float32)}
    d2["result"][0, 0] = -4
    d2["error"][1, 1] = 1e-3
    m = np.eye(4, dtype=np.float32)
    return (mod.compare_float("t", a, b, out=out),
            mod.compare_float("t", a, a, out=out),
            mod.compare_float3("v", l, r, out=out),
            mod.compare_normal("n", l, r, out=out),
            mod.compare_matrix4("m", m, m + 1e-6, out=out),
            mod.compare_track_data("td", d1, d2, out=out))


def test_comparators_count_mismatches_match_jax():
    outs = [io.StringIO(), io.StringIO()]
    counts = [_comparisons(mod, out)
              for mod, out in zip((tcompare, jcompare), outs)]
    assert counts[0] == counts[1] == (1, 0, 2, 1, 16, 2)
    assert outs[0].getvalue() == outs[1].getvalue()
    assert tcompare.EPSILON == jcompare.EPSILON == 1e-7


def test_tum_roundtrip_and_ate_match_jax(tmp_path):
    xs = [np.array([0.1 * i, 0.0, 0.02 * i, 0, 0.01 * i, 0], np.float32)
          for i in range(10)]
    poses = np.stack([se3_exp(torch.from_numpy(x)).numpy() for x in xs])
    np.testing.assert_allclose(
        poses, np.stack([np.asarray(j_se3_exp(jnp.asarray(x))) for x in xs]),
        atol=1e-6)
    pt, pj = str(tmp_path / "t.tum"), str(tmp_path / "j.tum")
    ttraj.write_tum(pt, poses)
    jtraj.write_tum(pj, poses)
    assert open(pt).read() == open(pj).read()
    pos = ttraj.read_tum(pt)
    np.testing.assert_array_equal(pos, jtraj.read_tum(pt))
    np.testing.assert_allclose(pos, poses[:, :3, 3], atol=1e-5)
    gt = poses[:, :3, 3]
    shifted = gt + np.array([0.5, 0, 0])
    for est, align in ((pos, False), (shifted, False), (shifted, True)):
        assert ttraj.ate_rmse(est, gt, align) == jtraj.ate_rmse(est, gt,
                                                                align)
    assert abs(ttraj.ate_rmse(shifted, gt, align=False) - 0.5) < 1e-6
    assert ttraj.ate_rmse(shifted, gt, align=True) < 1e-6


def test_debug_dumps_match_jax(tmp_path):
    """write_buffer / write_pose give JAX's files; read_buffer loads
    them back."""
    pose = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    buf = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    for mod, sub in ((tdump, "t"), (jdump, "j")):
        d = tmp_path / sub
        d.mkdir()
        out = io.StringIO()
        assert mod.write_buffer(str(d / "depth_"), 3, buf, out=out) == 24
        mod.write_pose(str(d / "pose_"), 3, pose, out=out)
    for name in ("depth_3", "pose_3", "BINARY_pose_3"):
        assert (tmp_path / "t" / name).read_bytes() \
            == (tmp_path / "j" / name).read_bytes(), name
    back = tdump.read_buffer(str(tmp_path / "t" / "depth_"), 3, np.int16,
                             (2, 3, 4))
    np.testing.assert_array_equal(back, buf)


def test_dump_volume_format_matches_jax(tmp_path):
    """The port's volume dump: int16 value shorts, x-fastest, the bytes
    of JAX's dump of the same state (reference: cpp/kernels.cpp:
    1006-1030)."""
    kf = KFusion(*KF_ARGS, device=CPU)
    st = kf.init_state()
    path = str(tmp_path / "vol.bin")
    kf.dump_volume(st, path)
    raw = np.fromfile(path, dtype="<i2")
    assert raw.size == 8 * 8 * 8 and (raw == 32766).all()
    tsdf = st.tsdf.clone()
    tsdf[0, 0, 3] = 1234            # voxel (x=3, y=0, z=0)
    tsdf[2, 5, 1] = -77
    kf.dump_volume(dataclasses.replace(st, tsdf=tsdf), path)
    raw = np.fromfile(path, dtype="<i2")
    assert raw[3] == 1234 and raw[(2 * 8 + 5) * 8 + 1] == -77
    jkf = JKFusion(*KF_ARGS)
    jst = dataclasses.replace(jkf.init_state(),
                              tsdf=jnp.asarray(tsdf.numpy()))
    jkf.dump_volume(jst, str(tmp_path / "jvol.bin"))
    assert open(path, "rb").read() \
        == open(tmp_path / "jvol.bin", "rb").read()


def _sphere_tsdf(n=48, r_frac=0.3, mu_vox=4.0):
    i = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(i, i, i, indexing="ij")
    d = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - r_frac
    return np.clip(d * n / mu_vox, -1.0, 1.0).astype(np.float32)


def test_sphere_mesh_geometry_matches_jax():
    n, r_frac, dim = 48, 0.3, 2.0
    vol = _sphere_tsdf(n, r_frac)
    verts, tris = tmesh.surface_nets(vol, dim=(dim,) * 3)
    jverts, jtris = jmesh.surface_nets(vol, dim=(dim,) * 3)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    assert len(verts) > 1000 and len(tris) >= 2 * len(verts) - 100
    r = np.linalg.norm(verts - dim / 2, axis=1)
    assert abs(r.mean() - r_frac * dim) < 0.25 * dim / n
    assert np.abs(r - r_frac * dim).max() < 0.75 * dim / n
    a, b, c = (verts[tris[:, k]] - dim / 2 for k in range(3))
    vol_signed = np.sum(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
    want = 4 / 3 * np.pi * (r_frac * dim) ** 3
    assert abs(vol_signed - want) / want < 0.05


def test_mesh_export_cli_from_port_dump(tmp_path):
    """A sphere written into a port state, dumped by
    ``KFusion.dump_volume`` and by ``save_state``: the port's CLI meshes
    both to JAX's PLY bytes, and load_tsdf inverts the dump."""
    n = 32
    vol = _sphere_tsdf(n)
    kf = KFusion((32, 24), (n,) * 3, (2.0,) * 3, (1.0, 1.0, 0.0), (2, 2),
                 (30.0, 30.0, 16.0, 12.0), device=CPU)
    st = dataclasses.replace(
        kf.init_state(),
        tsdf=torch.from_numpy(np.trunc(vol * 32766).astype(np.int16)))
    dump = str(tmp_path / "vol.dump")
    kf.dump_volume(st, dump)
    ckpt = str(tmp_path / "state.npz")
    save_state(ckpt, st, 4)

    plys = []
    for module, src, name in (
            ("slambench_tpu_torch.tools.mesh_export", dump, "t.ply"),
            ("slambench_tpu.tools.mesh_export", dump, "j.ply"),
            ("slambench_tpu_torch.tools.mesh_export", ckpt, "c.ply")):
        out = tmp_path / name
        r = subprocess.run([sys.executable, "-m", module, src, "-o",
                            str(out), "--dim", "2.0"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        plys.append(out.read_bytes())
    assert plys[0] == plys[1] == plys[2]
    head = plys[0][:200]
    assert head.startswith(b"ply\nformat binary_little_endian")
    n_v = int([ln for ln in head.split(b"\n")
               if ln.startswith(b"element vertex")][0].split()[-1])
    assert n_v > 200
    back = tmesh.load_tsdf(dump, None)
    assert back.shape == (n, n, n)
    assert np.abs(back - vol).max() <= 1.5 / 32766

    obj = tmp_path / "mesh.obj"
    verts, tris = tmesh.surface_nets(back, dim=(2.0,) * 3)
    tmesh.write_obj(str(obj), verts, tris)
    lines = obj.read_text().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(verts)
    assert sum(ln.startswith("f ") for ln in lines) == len(tris)
