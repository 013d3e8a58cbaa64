"""The comparison that decides ``correct``.

Two checks of what the window's calls of ``compute_frames_scan``
produced, against the plain reference (``reference.py``):

* **sample**: one window call drawn from the seed (a reservoir sample,
  ``Reservoir``). The reference starts from the program's state before
  that call (its volume, pose and reference maps: a trajectory's
  floating-point differences grow over long runs, so it follows the
  program from there) and runs the call's frames. Four numbers:

  - ``depth_mm``: the largest gap (mm) between the program's mm2meters
    and bilateral maps of the call's last frame and the reference's of
    the same frame (preprocessing);
  - ``pose_mm``: the largest gap (mm) between the camera positions the
    call gave and those of the reference over its frames (tracking);
  - ``tsdf_pct``: the share (%) of voxels observed on either side whose
    weight differs or whose value differs by more than 1e-4 (a
    hundredth of a millimetre of signed distance at mu 0.1 m, 3.3
    steps of the int16 TSDF) between the program's volume after the
    call and the reference's (integration). At the weight cap of 100 a
    left-out integrate moves a value by a hundred-and-first of the new
    sample's difference, which a coarser tolerance would not see;
  - ``raycast_pct``: the share (%) of pixels hit on either side where
    only one side hits, the vertices lie over 1 mm apart or the normals
    over 2.6 degrees, between the program's reference maps after the
    call and the reference's raycast of the program's volume from the
    program's pose (raycasting).

* **start**: the reference from a fresh state over set-up's frames 0-4
  and the window's first call, against the positions the program gave
  for those frames: ``start_pose_mm``, the largest gap (mm). The
  reference takes nothing from the program here.

``standin`` puts another in the program's place (``compare(...,
standin_name=...)``): the control, the reference computed in bfloat16,
or the float32 reference with a fault planted, each of which the
comparison has to judge not correct.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional

import numpy as np
import torch

from kfbench.reference import INVALID, TSDF_INV_SCALE, Reference, run_frames

NUMBERS = ("depth_mm", "pose_mm", "tsdf_pct", "raycast_pct", "start_pose_mm")
STANDINS = ("control", "unchanged", "half_batch", "skip_integrate",
            "altered")
VALUE_TOL = 1e-4         # 3.3 steps of the int16 TSDF
VERTEX_TOL_M = 1e-3
NORMAL_COS = 0.999


class Reservoir:
    """A uniform sample of one window call, drawn from the seed as the
    calls come (reservoir sampling), holding only the drawn call's
    states."""

    def __init__(self, seed: int, last: bool = False):
        self.rng = random.Random(int(seed) * 7919 + 17)
        self.last = last        # keep the last call (the stand-ins' runs)
        self.count = 0
        self.kept: Optional[dict] = None

    def offer(self, call: int, first: int, before, after,
              rows: torch.Tensor) -> None:
        self.count += 1
        if self.last or self.rng.random() * self.count < 1.0:
            self.kept = {"call": call, "first": first, "before": before,
                         "after": after, "rows": rows}


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def _leaf(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def map_gap_mm(prog, ref: dict) -> float:
    dev = ref["float_depth"].device
    return 1e3 * max(_gap(_leaf(prog, "float_depth").to(dev),
                          ref["float_depth"]),
                     _gap(_leaf(prog, "scaled_depth0").to(dev),
                          ref["scaled_depth0"]))


def rows_gap_mm(prog_rows, ref_rows) -> float:
    pr = np.asarray(prog_rows, np.float64)
    rr = np.asarray(ref_rows, np.float64)
    if pr.shape != rr.shape or not np.isfinite(pr).all():
        return math.inf
    return 1e3 * float(np.linalg.norm(pr - rr, axis=1).max())


def tsdf_gap_pct(prog, ref: dict, slab: int = 32) -> float:
    tp, wp = _leaf(prog, "tsdf"), _leaf(prog, "weight")
    tr, wr = ref["tsdf"], ref["weight"]
    dev = tr.device
    differ = seen = 0
    for z0 in range(0, tr.shape[0], slab):
        sl = slice(z0, z0 + slab)
        a, b = tp[sl].to(dev), tr[sl]
        wa, wb = wp[sl].to(dev), wr[sl]
        obs = (wa > 0) | (wb > 0)
        dv = (a.float() - b.float()).abs() * TSDF_INV_SCALE
        bad = obs & ((dv > VALUE_TOL) | (wa != wb))
        differ += int(bad.sum())
        seen += int(obs.sum())
    return 100.0 * differ / max(seen, 1)


def raycast_gap_pct(prog, ref: dict) -> float:
    dev = ref["ref_vertex"].device
    vp = _leaf(prog, "ref_vertex").to(dev).double()
    np_ = _leaf(prog, "ref_normal").to(dev).double()
    vr = ref["ref_vertex"].double()
    nr = ref["ref_normal"].double()
    hp, hr = (vp != 0).any(0), (vr != 0).any(0)
    dv = torch.sqrt(((vp - vr) ** 2).sum(0))
    cos = (np_ * nr).sum(0)
    valid_differs = (np_[0] == INVALID) != (nr[0] == INVALID)
    far = (dv > VERTEX_TOL_M) | ~(cos >= NORMAL_COS) | valid_differs
    bad = (hp != hr) | (hp & hr & far)
    either = hp | hr
    return 100.0 * float((bad & either).sum()) / max(int(either.sum()), 1)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS)


def _positions(st: dict, n: int) -> list:
    return [st["pose"][:3, 3].double().cpu().numpy()] * n


def standin(name: str, ref: Reference, low: Optional[Reference], before,
            depths: torch.Tensor, first: int):
    """(state, positions) that the stand-in ``name`` gives in the
    program's place over a call's frames ``depths`` from the program's
    state ``before``: the control (``low``, the reference in bfloat16),
    or the float32 reference with one fault planted:

    - ``unchanged``: every step returns its state unchanged;
    - ``half_batch``: the first half of the frames run, the rest left
      out (their positions repeat the last one run);
    - ``skip_integrate``: the last frame's integrate left out, the
      subtlest loss once the weights sit at their cap of 100;
    - ``altered``: every hit of the last raycast 2 cm deeper."""
    n = depths.shape[0]
    if name == "control":
        return run_frames(low, low.from_program(before), depths, first)
    st = ref.from_program(before)
    if name == "unchanged":
        return st, _positions(st, n)
    if name == "half_batch":
        st, rows = run_frames(ref, st, depths[:max(1, n // 2)], first)
        return st, rows + rows[-1:] * (n - len(rows))
    if name == "skip_integrate":
        st, rows = run_frames(ref, st, depths[:-1], first)
        st = dict(st)
        st["float_depth"] = ref.mm2meters(depths[-1].to(ref.dev))
        st["scaled_depth0"] = ref.bilateral(st["float_depth"])
        st = ref.tracking(st)
        if first + n - 1 > 2:
            st = ref.raycast(st)
        return st, rows + [st["pose"][:3, 3].double().cpu().numpy()]
    if name == "altered":
        st, rows = run_frames(ref, st, depths, first)
        st = dict(st)
        hit = (st["ref_vertex"] != 0).any(0)
        st["ref_vertex"] = st["ref_vertex"].clone()
        st["ref_vertex"][2] += torch.where(hit, 0.02, 0.0).to(
            st["ref_vertex"].dtype)
        return st, rows
    raise ValueError(f"unknown stand-in {name!r}: use one of "
                     f"{', '.join(STANDINS)}")


def compare(setting: dict, device, start: dict, sample: dict,
            stream_depths, standin_name: Optional[str] = None
            ) -> Dict[str, float]:
    """The five numbers (module docstring). ``start`` holds the program's
    ``frames`` and their ``rows`` from frame 0; ``sample`` the sampled
    call's ``first`` frame, ``frames``, ``before`` and ``after`` states
    and ``rows``. With ``standin_name`` a stand-in (``standin``) takes
    the program's place in the sample; the control takes it in the
    start too."""
    control = standin_name == "control"
    ref = Reference(setting, device)
    low = Reference(setting, device, torch.bfloat16) if control else None
    depths = stream_depths(sample["first"], sample["frames"])
    followed, ref_rows = run_frames(ref, ref.from_program(sample["before"]),
                                    depths, sample["first"])
    prog, prog_rows = sample["after"], sample["rows"]
    if standin_name is not None:
        prog, prog_rows = standin(standin_name, ref, low, sample["before"],
                                  depths, sample["first"])
    last = {"float_depth": ref.mm2meters(depths[-1])}
    last["scaled_depth0"] = ref.bilateral(last["float_depth"])
    seen = ref.raycast({"tsdf": _leaf(prog, "tsdf").to(ref.dev),
                        "pose": _leaf(prog, "raycast_pose").to(ref.dev)
                        .float()})
    out = {"depth_mm": map_gap_mm(prog, last),
           "pose_mm": rows_gap_mm(prog_rows, ref_rows),
           "tsdf_pct": tsdf_gap_pct(prog, followed),
           "raycast_pct": raycast_gap_pct(prog, seen)}
    del followed, seen, prog
    depths = stream_depths(0, start["frames"])
    _, ref_rows = run_frames(ref, None, depths, 0)
    prog_rows = start["rows"]
    if control:
        _, prog_rows = run_frames(low, None, depths, 0)
    out["start_pose_mm"] = rows_gap_mm(prog_rows, ref_rows)
    return out
