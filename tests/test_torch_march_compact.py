"""The port's two-phase straggler march (``ops/raycast_fast.py:
march_two_phase``) and the ``SLAMBENCH_*`` knobs of the raycast.

* Against JAX's ``raycast_fast_maps`` (its own two-phase march) on the
  analytic sphere of ``tests/test_raycast_fast.py``, with
  ``MARCH_PHASE1`` = 6 (the overflow branch in both) and the default 24
  (the compact branch), at the port's fast-vs-JAX gates
  (``tests/test_torch_raycast.py``: <= 2 hit mismatches, p95 |dv| < 0.5
  voxel, max < 2 voxels, normal dot > 0.99 on >= 95% of common hits).
* Against the port's own single-phase march, bit for bit, in each of
  the three branches (none live, compacted, overflow at full width),
  and the graph route's full-budget march.
* The knobs parsed as JAX parses them: defaults and clamps, compared
  with JAX's module reloaded under the same environment."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402

from slambench_tpu_torch import geometry as G  # noqa: E402
from slambench_tpu_torch.ops import raycast_fast as rf  # noqa: E402

torch.set_num_threads(2)
DIM = (2.0, 2.0, 2.0)
VOXEL = 2.0 / 64


def _sphere_volume(res=64, dimv=2.0, center=(1.0, 1.0, 1.4), radius=0.3,
                   mu=0.2):
    """tests/test_raycast_fast.py's sphere, int16 numpy."""
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2) - radius
    sdf = np.clip(d / mu, -1, 1).astype(np.float32)
    return np.trunc(sdf * 32766).astype(np.int16)


@pytest.fixture(scope="module")
def sphere():
    """(tsdf, port args, JAX args) for the 24x32 view of the sphere."""
    tsdf = _sphere_volume()
    k = np.array([60.0, 60.0, 16.0, 12.0], np.float32)
    pose = np.asarray(JG.translation_pose([1.0, 1.0, 0.2]))
    view_j = JG.mat4mul(jnp.asarray(pose),
                        JG.get_inverse_camera_matrix(jnp.asarray(k)))
    view_t = G.mat4mul(torch.from_numpy(pose.copy()),
                       G.get_inverse_camera_matrix(torch.from_numpy(k)))
    tail = ((24, 32), 0.1, 4.0, VOXEL, 0.15)
    return tsdf, (DIM, view_t) + tail, (DIM, view_j) + tail


def _march(tsdf, args, **knobs):
    """The port's maps and the counters of the march that made them."""
    t = torch.from_numpy(tsdf)
    rf.reset_counters()
    maps = rf.raycast_fast_maps(t, rf.make_min_mip(t), *args, **knobs)
    return maps, dict(rf.march_counts)


@pytest.mark.parametrize("phase1,branch", [(6, "full"), (24, "compact")])
def test_two_phase_matches_jax_on_sphere(sphere, monkeypatch, phase1,
                                         branch):
    from slambench_tpu.ops import raycast_fast as jrf
    from slambench_tpu.ops.raycast_fast import (
        make_min_mip as j_min_mip, raycast_fast_maps as j_maps,
    )
    tsdf, args_t, args_j = sphere
    monkeypatch.setattr(jrf, "MARCH_PHASE1", phase1)
    vj, nj, tj = map(np.asarray, j_maps(jnp.asarray(tsdf),
                                        j_min_mip(jnp.asarray(tsdf)),
                                        *args_j))
    (vt, nt, tt), counts = _march(tsdf, args_t, phase1=phase1)
    assert counts[branch] == 1, counts
    vt, nt = vt.numpy(), nt.numpy()
    ht, hj = nt[0] != -2, nj[0] != -2
    assert (ht ^ hj).sum() <= 2
    m = ht & hj
    assert m.sum() > 50
    dv = np.abs(vt[:, m] - vj[:, m]).max(axis=0)
    assert np.percentile(dv, 95) < 0.5 * VOXEL
    assert dv.max() < 2 * VOXEL
    assert ((nt[:, m] * nj[:, m]).sum(0) > 0.99).mean() >= 0.95


@pytest.mark.parametrize("branch,knobs,lanes", [
    ("none", dict(phase1=64), None),
    ("compact", dict(phase1=12), 128),
    ("compact", dict(phase1=6, slot_frac=1), 24 * 32),
    ("full", dict(phase1=6), 24 * 32),
    ("full", dict(phase1=1, slot_frac=10 ** 6), 24 * 32),
], ids=["none", "compact", "compact_all_slots", "full", "full_few_slots"])
def test_two_phase_equals_single_phase_bit_for_bit(sphere, branch, knobs,
                                                   lanes):
    """Every branch gives the single-phase march's bits (the same total
    budget), and so does the graph route's full-budget march. Phase 2
    runs on ``lanes`` rays: 128 slots for 768 rays at the default
    ``MARCH_SLOTS`` (8), all 768 at 1; the overflow cases have more
    stragglers than their 128 slots and finish at full width."""
    tsdf, args, _ = sphere
    got, counts = _march(tsdf, args, **knobs)
    assert counts[branch] == 1, counts
    budget1 = -(-knobs["phase1"] // 4) * 4
    if lanes:
        assert counts["phase1_substeps"] == budget1
        assert counts["phase2_ray_substeps"] \
            == lanes * counts["phase2_substeps"] > 0
    else:                       # every ray done within phase 1
        assert counts["phase1_substeps"] < budget1
        assert counts["phase2_substeps"] == 0
    want, single = _march(tsdf, args, compact=False,
                          phase1=knobs["phase1"])
    assert single["phase2_substeps"] == 0
    graph, full = _march(tsdf, args, early_exit=False,
                         phase1=knobs["phase1"])
    assert full["phase1_substeps"] > single["phase1_substeps"]
    for g, w, f in zip(got, want, graph):
        assert torch.equal(g, w)
        assert torch.equal(f, w)
    assert (want[2] > 0).sum() > 50


def _jax_knobs(monkeypatch, env):
    """JAX's module-level knobs under ``env`` (reloaded, then restored
    to the defaults)."""
    from slambench_tpu.ops import raycast_fast as jrf
    names = ("SLAMBENCH_MIP_BLOCK", "SLAMBENCH_SKIP_MAX_D",
             "SLAMBENCH_MARCH_UNROLL", "SLAMBENCH_MARCH_COMPACT",
             "SLAMBENCH_MARCH_PHASE1", "SLAMBENCH_MARCH_SLOTS",
             "SLAMBENCH_RAYCAST_NSCAN", "SLAMBENCH_RAYCAST_REFINE")
    for n in names:
        monkeypatch.delenv(n, raising=False)
    for n, v in env.items():
        monkeypatch.setenv(n, v)
    try:
        importlib.reload(jrf)
        return {k: getattr(jrf, k) for k in (
            "MIP_BLOCK", "SKIP_MAX_D", "MARCH_UNROLL", "MARCH_COMPACT",
            "MARCH_PHASE1", "MARCH_SLOT_FRAC", "RAYCAST_NSCAN",
            "RAYCAST_REFINE_ITERS")}
    finally:
        for n in names:
            monkeypatch.delenv(n, raising=False)
        importlib.reload(jrf)


@pytest.mark.parametrize("env", [
    {},
    {"SLAMBENCH_MARCH_UNROLL": "0", "SLAMBENCH_MARCH_SLOTS": "-3"},
    {"SLAMBENCH_MIP_BLOCK": "16", "SLAMBENCH_SKIP_MAX_D": "5",
     "SLAMBENCH_MARCH_UNROLL": "2", "SLAMBENCH_MARCH_COMPACT": "0",
     "SLAMBENCH_MARCH_PHASE1": "6", "SLAMBENCH_MARCH_SLOTS": "4",
     "SLAMBENCH_RAYCAST_NSCAN": "8", "SLAMBENCH_RAYCAST_REFINE": "3"},
], ids=["defaults", "clamps", "set"])
def test_knobs_parse_as_jax(monkeypatch, env):
    assert rf.read_knobs(env) == _jax_knobs(monkeypatch, env)


@pytest.mark.parametrize("name,value", [
    ("SLAMBENCH_MIP_BLOCK", "eight"), ("SLAMBENCH_RAYCAST_NSCAN", "4.5"),
    ("SLAMBENCH_MARCH_PHASE1", "")])
def test_malformed_knob_raises_as_jax(monkeypatch, name, value):
    """A value that is not an integer raises ValueError in both; the
    port's names the variable."""
    with pytest.raises(ValueError, match=name):
        rf.read_knobs({name: value})
    with pytest.raises(ValueError):
        _jax_knobs(monkeypatch, {name: value})


@pytest.mark.parametrize("name,value", [
    ("SLAMBENCH_MARCH_COMPACT", "yes"), ("SLAMBENCH_MIP_BLOCK", "0"),
    ("SLAMBENCH_RAYCAST_NSCAN", "0"), ("SLAMBENCH_RAYCAST_REFINE", "-1")])
def test_knob_no_march_can_run_with_raises(name, value):
    with pytest.raises(ValueError, match=name):
        rf.read_knobs({name: value})
