"""Integrate a power report into per-rail energy.

A copy of ``slambench_tpu/tools/process_power_rpt.py`` (the port
imports nothing of the JAX package).

Equivalent of the reference's Tcl ``processPowerRpt`` script
(reference: kfusion/thirdparty/processPowerRpt, README.md:405): reads a
whitespace table whose first column is a timestamp in seconds and whose
remaining columns are watts per rail (header row names the rails —
the format written by PerfStats/PowerMonitor dumps), trapezoid-
integrates each rail over time and prints joules.

CLI: python -m slambench_tpu_torch.tools.process_power_rpt <power.rpt>
"""

from __future__ import annotations

import sys

import numpy as np


def integrate_report(path: str) -> dict:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split()
    data = np.array([[float(x) for x in ln.split()] for ln in lines[1:]])
    t = data[:, 0]
    out = {}
    for i, name in enumerate(header[1:], start=1):
        out[name] = float(np.trapezoid(data[:, i], t)) \
            if hasattr(np, "trapezoid") else float(np.trapz(data[:, i], t))
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: process_power_rpt <power.rpt>", file=sys.stderr)
        return 1
    energies = integrate_report(argv[0])
    total = 0.0
    for name, joules in energies.items():
        print("%-16s %12.4f J" % (name, joules))
        total += joules
    print("%-16s %12.4f J" % ("TOTAL", total))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
