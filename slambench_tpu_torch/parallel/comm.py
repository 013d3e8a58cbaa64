"""Collective-traffic account of the sharded step (port of
``slambench_tpu/parallel/comm.py``).

``analytic_traffic`` gives each frame's collective payload in closed
form from the step's structure (``parallel/step.py``): the halo
exchange, the raycast's ``pmin`` / ``psum``, one 32-float ``psum`` an
ICP iteration and the ``all_gather``s of the result codes and of the
filtered depth bands. The JAX package checks it against the collectives
in the compiled step's HLO; the port compiles nothing, so its evidence
is the mesh's own tally of a frame (``parallel/mesh.Mesh.tally``, keyed
by the lines below), held against this account by the tests and by
``chip_smoke.py``.

``tools/scaling_report.py`` combines it with measured single-card phase
times into a projected scaling curve.
"""

from __future__ import annotations

from typing import Dict


def analytic_traffic(kf, icp_iters: int | None = None) -> Dict[str, dict]:
    """Per-frame collective traffic of ``ShardedKFusion``'s step, in
    closed form. Bytes are each collective's result buffer on one rank
    (for the halo, the planes one rank sends its two neighbours).

    ``icp_iters`` defaults to the pyramid's whole budget (the reference's
    10+5+4 = 19), which the port always runs: a converged level freezes
    its state but still reduces."""
    H, W = kf.H, kf.W
    iters = sum(kf.iterations) if icp_iters is None else icp_iters
    halo_bytes = 2 * kf.halo * kf.volume_resolution[0] \
        * kf.volume_resolution[1] * 2      # 2 directions, int16 planes
    out = {
        "halo_ppermute": {
            "bytes": halo_bytes,
            "count": 2,
            "what": f"{kf.halo} tsdf z-planes to each neighbour "
                    "(raycast halo, parallel/step.py:_halo_exchange)",
        },
        "raycast_pmin": {
            "bytes": H * W * 4,
            "count": 1,
            "what": "first-hit t composition across slabs (f32[H,W] min)",
        },
        "raycast_psum_normal": {
            "bytes": 3 * H * W * 4,
            "count": 1,
            "what": "owning-slab gradient normals (f32[3,H,W] sum)",
        },
        "icp_psum": {
            "bytes": iters * 32 * 4,
            "count": iters,
            "what": "packed normal equations, one f32[32] per ICP "
                    "iteration (the whole budget)",
        },
        "track_result_all_gather": {
            "bytes": H * W * 4,
            "count": 1,
            "what": "level-0 diagnostic result map reassembly (i32 rows)",
        },
    }
    # The banded bilateral filter runs when the rows divide by the mesh
    # (parallel/step.py:_sharded_preprocessing); otherwise preprocessing
    # is replicated and gathers nothing. The port takes the band route
    # under every backend name, where JAX keeps the Pallas tier
    # replicated.
    n = getattr(kf, "n_shards", 1)
    if n > 1 and H % n == 0:
        out["preprocess_all_gather"] = {
            "bytes": H * W * 4,
            "count": 1,
            "what": "row-sharded bilateral-filter band reassembly "
                    "(f32 rows, parallel/step.py:_sharded_preprocessing)",
        }
    total = sum(v["bytes"] for v in out.values())
    out["total"] = {"bytes": total, "count": None,
                    "what": "per-frame per-device collective payload"}
    return out


def tally_matches(tally: Dict[str, dict], model: Dict[str, dict]) -> list:
    """The lines where a mesh's tally of one frame differs from
    ``analytic_traffic``'s (count or bytes); empty when they agree. The
    transport's own line (``halo_all_gather_extra``) has no counterpart
    in the account and is left out."""
    bad = []
    for key in sorted(set(model) | set(tally)):
        if key in ("total", "halo_all_gather_extra"):
            continue
        want = model.get(key, {"count": 0, "bytes": 0})
        got = tally.get(key, {"count": 0, "bytes": 0})
        if (got["count"], got["bytes"]) != (want["count"], want["bytes"]):
            bad.append(f"{key}: tally {got['count']} calls / {got['bytes']}"
                       f" bytes, account {want['count']} / {want['bytes']}")
    return bad
