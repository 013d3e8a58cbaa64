"""Projected multi-card scaling of the sharded step from measured
single-card phase times and the analytic collective account (port of
``slambench_tpu/tools/scaling_report.py``).

This is a projection, not a measurement: it divides the single-card
phase times of ``tools/profile_frame.py`` (its ``phase_ms``; for the
integrate its ``integrate_blocks_<grid>_plus_mip`` row where the
profile has one, as JAX's report prefers it) by the rank count and
adds each frame's collectives (``parallel/comm.py``) at a link rate and
a per-hop latency. ``tools/mesh_wallclock.py`` measures
what the sharded program adds on one card.

Model per n-rank mesh (1-D z mesh, ``parallel/step.py``):
  tracking     : compute/n (row blocks) + iters * psum(32 floats)
  integration  : compute/n (slab-local, no communication)
  raycasting   : compute/n (slab t-intervals partition the ray extent)
                 + halo exchange + pmin/psum image composition
  preprocessing: replicated (K1F; the banded K1 of n > 1 is counted as
                 replicated too, an upper bound on a sub-ms phase)
Collective time = bytes / link rate + hops * latency; hops = 1 for the
halo (one neighbour step), 2(n-1) for an all-reduce, n-1 for an
all-gather.

The link default is the H100 SXM's NVLink 4 rate, 450 GB/s each way
(NVIDIA's data sheet: 900 GB/s to the host's other cards, all to all);
the 1 us hop latency is an assumption, not a measurement.

Usage: python -m slambench_tpu_torch.tools.scaling_report --profile p.json
       [--image 320x240] [--volume 256] [--link-gbps 450] [--markdown]
"""

from __future__ import annotations

import argparse
import json
import math

NVLINK4_GBPS = 450.0     # H100 SXM NVLink 4, one direction (data sheet)


def _coll_time_us(nbytes: float, n: int, kind: str,
                  link_gbps: float, lat_us: float) -> float:
    if n <= 1:
        return 0.0
    if kind == "ppermute":            # one neighbour step
        hops = 1
        wire = nbytes
    elif kind == "allreduce":         # bidirectional ring: 2(n-1)/n
        hops = 2 * (n - 1)
        wire = 2 * nbytes * (n - 1) / n
    else:                             # all-gather
        hops = n - 1
        wire = nbytes * (n - 1) / n
    return wire / link_gbps / 1e3 + hops * lat_us


def halo_planes(volume: int, dim: float = 4.8, mu: float = 0.1,
                n: int = 2) -> int:
    """``ShardedKFusion``'s halo at a cubic volume (planes a side)."""
    return min(int(math.ceil(0.75 * mu / (dim / volume))) + 2, volume // n)


def integration_ms(profile: dict) -> float:
    """The integrate's ms a frame: as JAX's report does, the pipeline's
    frustum-culled block row (``integrate_blocks_<grid>_plus_mip``) when
    the profile has one with a time, else the integration phase."""
    for key, row in profile.items():
        if key.startswith("integrate_blocks_") \
                and key.endswith("_plus_mip") and isinstance(row, dict) \
                and row.get("ms") is not None:
            return float(row["ms"])
    return float(profile["phase_ms"].get("integration", 0.0))


def project_scaling(profile: dict, image=(320, 240), volume=256,
                    halo=None, link_gbps=NVLINK4_GBPS, lat_us=1.0,
                    icp_iters=19, ns=(1, 2, 4, 8),
                    frame_ms: float = 0.0):
    """Rows of {n, t_frame_ms, fps, efficiency, comm_ms, comm_bytes}
    from a ``tools/profile_frame.py`` JSON dict (its ``phase_ms``, ms a
    frame on one card). ``frame_ms`` rescales the phases to a measured
    frame time (e.g. a CUDA graph replay's), keeping their ratios."""
    W, H = image
    npix = W * H
    ph = profile["phase_ms"]
    t_pre = float(ph.get("preprocessing", 0.0))
    t_track = float(ph.get("tracking", 0.0))
    t_int = integration_ms(profile)
    t_ray = float(ph.get("raycasting", 0.0))
    if frame_ms:
        s = frame_ms / (t_pre + t_track + t_int + t_ray)
        t_pre, t_track, t_int, t_ray = (t * s for t in
                                        (t_pre, t_track, t_int, t_ray))
    rows = []
    t1 = None
    for n in ns:
        h = halo_planes(volume, n=n) if halo is None else halo
        halo_b = 2 * h * volume * volume * 2 if n > 1 else 0
        c_halo = _coll_time_us(halo_b, n, "ppermute", link_gbps, lat_us)
        c_ray = (_coll_time_us(npix * 4, n, "allreduce", link_gbps, lat_us)
                 + _coll_time_us(3 * npix * 4, n, "allreduce", link_gbps,
                                 lat_us))
        c_icp = icp_iters * _coll_time_us(32 * 4, n, "allreduce",
                                          link_gbps, lat_us)
        # Result-code reassembly + the preprocessing bands.
        c_gather = 2 * _coll_time_us(npix * 4, n, "allgather", link_gbps,
                                     lat_us)
        comm_ms = (c_halo + c_ray + c_icp + c_gather) / 1e3
        t = t_pre + (t_track + t_int + t_ray) / n + comm_ms
        if t1 is None:
            t1 = t
        rows.append({
            "n": n,
            "t_frame_ms": round(t, 3),
            "fps": round(1e3 / t, 2),
            "comm_ms": round(comm_ms, 3),
            "comm_bytes": 0 if n == 1 else int(
                halo_b + 4 * npix * 4 + icp_iters * 128 + 2 * npix * 4),
            "efficiency": round(t1 / t / n, 4),
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", required=True,
                    help="tools/profile_frame.py JSON (measured, one card)")
    ap.add_argument("--image", default="320x240")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--halo", type=int, default=None,
                    help="halo planes (default: the step's own)")
    ap.add_argument("--link-gbps", type=float, default=NVLINK4_GBPS,
                    help="link rate one way, GB/s (default: the H100 SXM's "
                         "NVLink 4 specification, 450)")
    ap.add_argument("--lat-us", type=float, default=1.0,
                    help="latency a hop, us (assumed)")
    ap.add_argument("--icp-iters", type=int, default=19)
    ap.add_argument("--frame-ms", type=float, default=0.0,
                    help="measured ms a frame to rescale the phases to")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    with open(args.profile) as f:
        profile = json.load(f)
    W, H = (int(x) for x in args.image.split("x"))
    rows = project_scaling(profile, image=(W, H), volume=args.volume,
                           halo=args.halo, link_gbps=args.link_gbps,
                           lat_us=args.lat_us, icp_iters=args.icp_iters,
                           frame_ms=args.frame_ms)
    note = (f"projection from {profile.get('device', '?')} phase times, "
            f"link {args.link_gbps} GB/s, {args.lat_us} us a hop: not "
            "measured")
    if args.markdown:
        print(f"{note}\n")
        print("| ranks | frame ms | fps | comm ms | comm MB/frame |"
              " efficiency |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['n']} | {r['t_frame_ms']} | {r['fps']} |"
                  f" {r['comm_ms']} | {r['comm_bytes']/1e6:.2f} |"
                  f" {r['efficiency']*100:.1f}% |")
    else:
        print(json.dumps({"note": note, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
