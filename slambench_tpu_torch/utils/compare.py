"""Epsilon buffer comparators for cross-backend debugging.

A copy of ``slambench_tpu/utils/compare.py`` (the port imports nothing
of the JAX package).

Re-implementation of the reference's comparison helpers used to diff a
GPU backend against the sequential C++ oracle buffers
(reference: kfusion/include/commons.h:414-518): same epsilon (1e-7), same
reporting style (print the first mismatches), but returning the mismatch
count so tests can assert on it.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

EPSILON = 1e-7  # reference: commons.h:414


def _report(name: str, idx, l, r, out, limit_state):
    if limit_state["n"] < limit_state["limit"]:
        print(f"Error into {name} at {idx}", file=out)
        print(f"l =  {l}", file=out)
        print(f"r =  {r}", file=out)
    limit_state["n"] += 1


def compare_float(name: str, l, r, epsilon: float = EPSILON,
                  out=sys.stderr, max_report: int = 10) -> int:
    """Element-wise |l - r| > epsilon count (reference: commons.h:434-442)."""
    l = np.asarray(l).reshape(-1)
    r = np.asarray(r).reshape(-1)
    bad = np.abs(l - r) > epsilon
    st = {"n": 0, "limit": max_report}
    for i in np.nonzero(bad)[0][:max_report]:
        _report(name, int(i), l[i], r[i], out, st)
    return int(bad.sum())


def compare_float3(name: str, l, r, epsilon: float = EPSILON,
                   out=sys.stderr) -> int:
    """Component-wise compare of [3, ...] maps (reference:
    commons.h:443-461)."""
    l = np.asarray(l).reshape(3, -1)
    r = np.asarray(r).reshape(3, -1)
    bad = (np.abs(l - r) > epsilon).any(axis=0)
    n = int(bad.sum())
    if n:
        i = int(np.nonzero(bad)[0][0])
        print(f"Error into {name} at {i}: l = {l[:, i]} r = {r[:, i]}",
              file=out)
    return n


def compare_matrix4(name: str, l, r, epsilon: float = EPSILON,
                    out=sys.stderr) -> int:
    """(reference: commons.h:488-490)."""
    return compare_float(name, np.asarray(l).reshape(-1),
                         np.asarray(r).reshape(-1), epsilon, out)


def compare_normal(name: str, l, r, epsilon: float = EPSILON,
                   out=sys.stderr) -> int:
    """Normals compare: y/z only checked where the reference normal is
    valid (x != -2) (reference: commons.h:499-518)."""
    l = np.asarray(l).reshape(3, -1)
    r = np.asarray(r).reshape(3, -1)
    bad_x = np.abs(l[0] - r[0]) > epsilon
    valid = r[0] != -2
    bad_yz = valid & ((np.abs(l[1] - r[1]) > epsilon)
                      | (np.abs(l[2] - r[2]) > epsilon))
    bad = bad_x | bad_yz
    n = int(bad.sum())
    if n:
        i = int(np.nonzero(bad)[0][0])
        print(f"Error into {name} at {i}: l = {l[:, i]} r = {r[:, i]}",
              file=out)
    return n


def compare_track_data(name: str, l: Dict, r: Dict,
                       epsilon: float = EPSILON, out=sys.stderr) -> int:
    """TrackData compare: result codes exactly, error within epsilon
    (reference: commons.h:416-432)."""
    n = 0
    lr = np.asarray(l["result"]).reshape(-1)
    rr = np.asarray(r["result"]).reshape(-1)
    bad_res = lr != rr
    n += int(bad_res.sum())
    if bad_res.any():
        i = int(np.nonzero(bad_res)[0][0])
        print(f"Error into {name} at {i}: l.result = {lr[i]} "
              f"r.result = {rr[i]}", file=out)
    le = np.asarray(l["error"]).reshape(-1)
    re_ = np.asarray(r["error"]).reshape(-1)
    valid = (lr >= 1) & (rr >= 1)
    bad_err = valid & (np.abs(le - re_) > epsilon)
    n += int(bad_err.sum())
    if bad_err.any():
        i = int(np.nonzero(bad_err)[0][0])
        print(f"Error into {name} at {i}: l.error = {le[i]} "
              f"r.error = {re_[i]}", file=out)
    return n
