"""The plain reference against the port, stage by stage, on the same
inputs at a small size on the CPU."""

import pytest
import torch

from conftest import small_setting
from kfbench import run, scene
from kfbench.reference import Reference

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    cfg = small_setting(width=160, volume=128)
    stream = scene.make_stream(cfg, 11, CPU)
    kf = run.make_kfusion(cfg, CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.compute_frame(state, stream["depth"][f],
                                 **run.setup_gates(f))
    return cfg, stream, kf, state, Reference(cfg, CPU)


def test_preprocessing(pair):
    cfg, stream, kf, state, ref = pair
    d = stream["depth"][5]
    s = kf.preprocessing(state, d)
    fd = ref.mm2meters(d)
    assert torch.equal(fd, s.float_depth)
    assert float((ref.bilateral(fd) - s.scaled_depth0).abs().max()) < 1e-5


def test_tracking_one_frame(pair):
    cfg, stream, kf, state, ref = pair
    s = kf.tracking(kf.preprocessing(state, stream["depth"][5]))
    r = ref.tracking(ref.from_program(kf.preprocessing(
        state, stream["depth"][5])))
    assert bool(s.tracked) and r["tracked"]
    assert float((s.pose - r["pose"]).abs().max()) < 1e-5


def test_integrate_one_frame(pair):
    cfg, stream, kf, state, ref = pair
    s = kf.tracking(kf.preprocessing(state, stream["depth"][5]))
    before = ref.from_program(s)
    s = kf.integration(s, integrate_frame=True, force_integrate=False)
    r = ref.integrate(before)
    assert torch.equal(r["weight"], s.weight)
    differ = (r["tsdf"].int() - s.tsdf.int()).abs()
    assert float((differ > 1).float().mean()) < 1e-3


def test_raycast_against_the_ports_oracle_march(pair):
    from slambench_tpu_torch.geometry import (
        get_inverse_camera_matrix, mat4mul)
    from slambench_tpu_torch.ops.raycast import raycast_maps
    cfg, stream, kf, state, ref = pair
    view = mat4mul(state.pose, get_inverse_camera_matrix(kf._k))
    v, n = raycast_maps(state.tsdf, kf.volume_dimensions, view,
                        (kf.H, kf.W), 0.4, 4.0, kf.step, 0.75 * kf.mu)
    r = ref.raycast(ref.from_program(state))
    hit_p, hit_r = (v != 0).any(0), (r["ref_vertex"] != 0).any(0)
    assert torch.equal(hit_p, hit_r)
    # The oracle interpolates over the detecting step; the reference
    # bisects the same bracket, so most hits agree to well under 1 mm.
    gap = ((v - r["ref_vertex"]) ** 2).sum(0).sqrt()[hit_p]
    assert float(gap.median()) < 1e-3
    cos = (n * r["ref_normal"]).sum(0)[hit_p]
    assert float(cos.median()) > 0.999


def test_updated_voxels_count_the_integrates_changes(pair):
    cfg, stream, kf, state, ref = pair
    s = kf.tracking(kf.preprocessing(state, stream["depth"][5]))
    after = kf.integration(s, integrate_frame=True, force_integrate=False)
    changed = int((after.weight != s.weight).sum())
    assert ref.updated_voxels(after.pose, after.float_depth) == changed
