"""Convert a device trace into ``name ns`` kernel lines (port of
``slambench_tpu/eval/xprof2log.py``).

Re-implementation of the reference's nvprof post-processor
(reference: kfusion/thirdparty/nvprof2log.py — converts
``nvprof --print-gpu-trace`` output into ``name nanoseconds`` lines for
checkKernels.py). The input is a Chrome-trace JSON: the one
``torch.profiler`` exports (``export_chrome_trace``; the CLI's
``KERNEL_TIMINGS=xprof`` route writes ``<dir>/kernels.trace.json``), or
the JAX package's ``*.trace.json.gz``. Every complete ('ph' == 'X')
event on a device lane becomes one ``name duration_ns`` line, so
``eval/check_kernels.py`` consumes either stream.

A device lane is a pid whose process name holds "TPU", "GPU" or
"/device:", or that holds a CUDA kernel, copy or fill event (torch's
categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``). A CUDA kernel's
name is demangled C++ (``void (anonymous namespace)::track_reduce_
kernel<...>(float const*, ...)``): the line keeps it without the
parameter list and the return type, with blanks as ``_``, so that it is
one field.

CLI:
  python -m slambench_tpu_torch.eval.xprof2log <trace_dir_or_file> [> kernels.log]

Accepts a directory (searched recursively for ``*.trace.json[.gz]``) or
a single trace file. ``--all`` keeps host lanes too (default: device
lanes only; a trace with no device lane then falls back to every lane).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Iterable, List, Tuple

DEVICE_TAGS = ("TPU", "GPU", "/device:")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_files(path: str) -> List[str]:
    """A trace file itself, or every trace file under a directory."""
    if os.path.isfile(path):
        return [path]
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits += glob.glob(os.path.join(path, "**", pat), recursive=True)
    return sorted(hits)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_pids(trace: dict) -> set:
    """pids of the device lanes: by process name, or by what they hold."""
    pids = set()
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = str(ev.get("args", {}).get("name", ""))
            if any(tag in name for tag in DEVICE_TAGS):
                pids.add(ev.get("pid"))
        elif ev.get("cat") in DEVICE_CATEGORIES:
            pids.add(ev.get("pid"))
    return pids


def short_name(name: str) -> str:
    """One field: the name without a trailing parameter list and a
    leading return type, blanks as ``_``."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    if name.startswith("void "):
        name = name[len("void "):]
    return "_".join(name.split())


def kernel_events(trace: dict, device_only: bool = True
                  ) -> Iterable[Tuple[str, float]]:
    """Yield (name, duration_ns) for complete events, on the device lanes
    only unless ``device_only`` is false (none when there is no device
    lane). Chrome-trace durations are microseconds."""
    pids = device_pids(trace) if device_only else None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if pids is not None and ev.get("pid") not in pids:
            continue
        dur_us = ev.get("dur", 0)
        if dur_us <= 0:
            continue
        name = short_name(str(ev.get("name", "")))
        if not name:
            continue
        yield name, float(dur_us) * 1e3


def convert(path: str, device_only: bool = True, out=sys.stdout) -> int:
    """Write ``name ns`` lines for every kernel event found; returns the
    number of lines emitted."""
    n = 0
    files = find_trace_files(path)
    if not files:
        print(f"no *.trace.json[.gz] under {path}", file=sys.stderr)
        return 0
    for f in files:
        trace = load_trace(f)
        events = list(kernel_events(trace, device_only=device_only))
        if not events and device_only:
            # A trace with no device lane (a CPU run): every lane rather
            # than nothing.
            events = list(kernel_events(trace, device_only=False))
        for name, ns in events:
            print(f"{name} {ns:.0f}", file=out)
            n += 1
    return n


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device_only = True
    if "--all" in argv:
        device_only = False
        argv.remove("--all")
    if len(argv) != 1:
        print("usage: xprof2log [--all] <trace_dir_or_file>",
              file=sys.stderr)
        return 1
    convert(argv[0], device_only=device_only)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
