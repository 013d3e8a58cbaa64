"""The port's communication account: ``parallel/comm.py:analytic_traffic``
against JAX's closed form, the mesh's tally of one executed frame
against it (the port's counterpart of JAX's HLO check), and the
projection tool ``tools/scaling_report.py``."""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu.parallel.comm import (  # noqa: E402
    analytic_traffic as janalytic,
)
from slambench_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from slambench_tpu.parallel.step import ShardedKFusion as JSharded  # noqa

from slambench_tpu_torch.parallel import distributed  # noqa: E402
from slambench_tpu_torch.parallel.comm import (  # noqa: E402
    analytic_traffic, tally_matches,
)
from slambench_tpu_torch.tools import scaling_report  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ((160, 120), (64, 64, 64), (4.8, 4.8, 4.8), (1.6, 2.4, 1.2),
        (10, 5, 4), (120.0, 120.0, 80.0, 60.0))

# A rank of a 4-rank mesh: 5 frames of a synthetic wall, rank 0 prints
# the tally of the last frame and the account as one JSON line.
WORKER = r'''
import json
import numpy as np, torch
torch.set_num_threads(1)
from slambench_tpu_torch.parallel import distributed
from slambench_tpu_torch.parallel.comm import analytic_traffic
from slambench_tpu_torch.parallel.step import ShardedKFusion
mesh = distributed.initialize(0, "cpu")
kf = ShardedKFusion((64, 48), (32, 32, 32), (4.8,) * 3, (1.6, 2.4, 1.2),
                    (10, 5, 4), (48.0, 48.0, 32.0, 24.0), mesh=mesh)
u, v = np.meshgrid(np.arange(64), np.arange(48))
depth = (1500 + 300 * np.sin(u / 9.0) * np.cos(v / 7.0)).astype(np.uint16)
state = kf.init_state()
for f in range(5):
    mesh.reset_tally()
    state = kf.process_frame(state, depth, f, integration_rate=1)
if mesh.rank == 0:
    print(json.dumps({"tally": mesh.tally, "model": analytic_traffic(kf),
                      "halo": kf.halo}))
mesh.close()
'''


def test_analytic_traffic_totals():
    """The port's account of a 4-rank mesh: the total is the sum of the
    lines, each line equals JAX's for the same configuration (the
    fast tier), and the order of magnitude holds (far under the volume)."""
    kf = types.SimpleNamespace(H=120, W=160, iterations=(10, 5, 4), halo=7,
                               volume_resolution=(64, 64, 64), n_shards=4)
    model = analytic_traffic(kf)
    parts = sum(v["bytes"] for k, v in model.items() if k != "total")
    assert model["total"]["bytes"] == parts
    assert model["total"]["bytes"] < 4 * 64 * 64 * 64
    jkf = JSharded(*ARGS, mesh=jmake_mesh(4))
    kf.halo = jkf.halo
    model, jmodel = analytic_traffic(kf), janalytic(jkf)
    assert set(model) == set(jmodel)
    for key in model:
        assert model[key]["bytes"] == jmodel[key]["bytes"], key
        assert model[key]["count"] == jmodel[key]["count"], key
    # No band gather where the rows do not divide (JAX's condition).
    kf.n_shards = 7
    assert "preprocess_all_gather" not in analytic_traffic(kf)
    assert analytic_traffic(kf, icp_iters=3)["icp_psum"]["bytes"] == 384


def test_tally_of_one_frame_matches_analytic():
    """Four gloo ranks run a frame of the sharded step; the mesh's tally
    of that frame equals the account, line for line (count and bytes)."""
    outs = distributed.launch(4, ["-c", WORKER], cwd=REPO, timeout=300)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    res = json.loads(outs[0][1].strip().splitlines()[-1])
    assert tally_matches(res["tally"], res["model"]) == []
    assert res["tally"]["icp_psum"]["count"] == 19
    assert res["tally"]["halo_ppermute"]["bytes"] \
        == 2 * res["halo"] * 32 * 32 * 2
    bad = dict(res["tally"], icp_psum={"count": 18, "bytes": 18 * 128})
    assert tally_matches(bad, res["model"]) == [
        "icp_psum: tally 18 calls / 2304 bytes, account 19 / 2432"]


def test_scaling_report_runs(tmp_path, capsys):
    profile = {"device": "test", "phase_ms": {
        "preprocessing": 0.5, "tracking": 60.0, "integration": 40.0,
        "raycasting": 80.0, "frame": 180.5}}
    rows = scaling_report.project_scaling(profile, image=(160, 120),
                                          volume=64, halo=10,
                                          link_gbps=45.0, lat_us=1.0,
                                          ns=(1, 2, 4, 8, 16))
    assert [r["n"] for r in rows] == [1, 2, 4, 8, 16]
    assert rows[0]["efficiency"] == 1.0 and rows[0]["comm_ms"] == 0.0
    effs = [r["efficiency"] for r in rows]
    assert all(e1 >= e2 for e1, e2 in zip(effs, effs[1:]))
    assert effs[3] > 0.5
    scaled = scaling_report.project_scaling(profile, frame_ms=90.25)
    assert scaled[0]["t_frame_ms"] == pytest.approx(90.25, abs=1e-3)
    assert scaling_report.halo_planes(256) == 7
    path = tmp_path / "p.json"
    path.write_text(json.dumps(profile))
    assert scaling_report.main(["--profile", str(path), "--markdown"]) == 0
    out = capsys.readouterr().out
    assert "projection from test phase times" in out and "not measured" in out
    assert out.count("\n| ") == 5 and "450.0 GB/s" in out
    assert scaling_report.main(["--profile", str(path)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert [r["n"] for r in res["rows"]] == [1, 2, 4, 8]
    assert np.isclose(res["rows"][0]["fps"], 1e3 / 180.5, atol=0.01)
