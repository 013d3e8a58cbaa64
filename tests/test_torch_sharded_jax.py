"""One sharded step of the port (``parallel/step.py``) at 2 gloo ranks
against JAX's ``ShardedKFusion`` on 2 virtual devices, from one
checkpoint that both packages load."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from slambench_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from slambench_tpu.parallel.step import ShardedKFusion as JSharded  # noqa
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402
from slambench_tpu.utils.checkpoint import load_state as jload  # noqa: E402

from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.parallel import distributed  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402
from slambench_tpu_torch.tools.mosaic_probe import K1_TOL  # noqa: E402
from slambench_tpu_torch.utils.checkpoint import save_state  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One rank: one step from the checkpoint; rank 0 saves the whole state.
WORKER = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from slambench_tpu_torch.parallel import distributed
from slambench_tpu_torch.parallel.step import ShardedKFusion
from slambench_tpu_torch.utils.checkpoint import load_state
job = json.loads(sys.argv[1])
mesh = distributed.initialize(0, "cpu")
kf = ShardedKFusion(*job["args"], mesh=mesh)
state, _ = load_state(job["state"], torch.device("cpu"))
state = kf.compute_frame(kf.local_state(state),
                         kf.to_device(np.load(job["depth"])), **job["gates"])
full = kf.full_state(state)
out = {name: getattr(full, name).numpy()
       for name in ("pose", "tsdf", "weight", "reduction", "track_result",
                    "scaled_depth0")}
out["tracked"] = bool(full.tracked)
out["slab"] = np.asarray(state.tsdf.shape)
if mesh.rank == 0:
    np.savez(job["out"], **out)
mesh.close()
'''


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("step_clip"))
    return TS.generate_dataset(out, CPU, n_frames=6, image_size=(160, 120),
                               dim=(4.8, 4.8, 4.8), amp=0.12)


def test_sharded_step_matches_jax_two_ranks(dataset, tmp_path):
    """One sharded step (every phase on) from a shared checkpoint: the
    port at 2 gloo ranks against JAX's ShardedKFusion on 2 virtual
    devices. Pose within the pipeline's 1e-4 m, tsdf within 1 LSB,
    weights and tracked equal, the banded filter's depth within K1's
    tolerance (the plain filter against JAX's, tools/mosaic_probe.py)."""
    man = dataset
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = [list(man["image_size"]), [64] * 3, list(man["dim"]), init,
            [10, 5, 4], list(man["camera"])]
    rd = RawDepthReader(man["raw"])
    frames = [np.ascontiguousarray(rd.read_next_depth_frame())
              for _ in range(6)]
    kf = KFusion(*args, device=CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, frames[f], f, integration_rate=1)
    path, depth = str(tmp_path / "state.npz"), str(tmp_path / "depth.npy")
    save_state(path, state, 5)
    np.save(depth, frames[5])
    gates = dict(tracking_on=True, integrate_frame=True,
                 force_integrate=False, raycast_on=True)
    job = {"args": args, "state": path, "depth": depth, "gates": gates,
           "out": str(tmp_path / "out.npz")}
    outs = distributed.launch(2, ["-c", WORKER, json.dumps(job)], cwd=REPO,
                              timeout=400)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    got = dict(np.load(job["out"]))

    mesh = jmake_mesh(2)
    jkf = JSharded(*args, mesh=mesh)
    leaves, _ = jload(path)
    specs = {name: NamedSharding(mesh, getattr(jkf._state_spec, name))
             for name in JState.__dataclass_fields__}
    js = JState(**{name: jax.device_put(getattr(leaves, name), specs[name])
                   for name in specs})
    js = jkf._sharded_step(js, jnp.asarray(frames[5]), **gates)

    assert tuple(got["slab"]) == (32, 64, 64)
    np.testing.assert_allclose(got["pose"], np.asarray(js.pose), atol=1e-4)
    assert bool(got["tracked"]) == bool(js.tracked) is True
    np.testing.assert_allclose(got["scaled_depth0"],
                               np.asarray(js.scaled_depth0), **K1_TOL)
    d = np.abs(got["tsdf"].astype(np.int32) - np.asarray(js.tsdf, np.int32))
    assert d.max() <= 1, f"{(d > 1).sum()} voxels beyond 1 LSB"
    np.testing.assert_array_equal(got["weight"], np.asarray(js.weight))
    same = got["track_result"] == np.asarray(js.track_result)
    assert same.mean() > 0.999
    np.testing.assert_allclose(got["reduction"], np.asarray(js.reduction),
                               rtol=1e-3, atol=1e-2)
