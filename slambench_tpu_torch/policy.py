"""Precision and device policy.

The JAX package runs every pose/intrinsics product and the ICP Gram
reduction at ``Precision.HIGHEST`` (slambench_tpu/geometry.py:58-63,
ops/track.py:123-127). The port's counterpart is full float32 for
matmuls and convolutions: TF32 off everywhere.
"""

from __future__ import annotations

import os
import platform
import sys

import torch


def apply_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (TF32 off) process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str) -> torch.device:
    """``torch.device`` for a CLI/device name; CUDA must really be there.

    No quiet fallback: asking for ``cuda`` without a usable card raises.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain-torch path on the CPU")
    return device


def device_report(device: torch.device, out=sys.stderr) -> None:
    """Print the platform and device table (the JAX package's
    ``utils/backend.py:device_report``; the reference reports its OpenCL
    platform and device, common_opencl.cpp:58-66)."""
    print(f"platform: {device.type} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda or 'none'})", file=out)
    if device.type != "cuda":
        print(f"  device 0: cpu {platform.machine()} "
              f"{platform.processor() or ''}".rstrip()
              + f", {os.cpu_count()} cores, {torch.get_num_threads()} "
              "torch threads", file=out)
        return
    chosen = device.index or 0
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  device {i}: cuda:{i} {p.name}, "
              f"{p.multi_processor_count} SMs, "
              f"{p.total_memory / 2 ** 30:.1f} GiB, "
              f"sm_{p.major}{p.minor}"
              + (" (selected)" if i == chosen else ""), file=out)


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
