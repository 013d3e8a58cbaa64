"""Precision and device policy.

The JAX package runs every pose/intrinsics product and the ICP Gram
reduction at ``Precision.HIGHEST`` (slambench_tpu/geometry.py:58-63,
ops/track.py:123-127). The port's counterpart is full float32 for
matmuls and convolutions: TF32 off everywhere.
"""

from __future__ import annotations

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


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
