"""K2 wrapper: the ICP normal-equations reduction as a hand-written CUDA
kernel.

Replaces ``slambench_tpu/ops/pallas/reduce.py:reduce_track_pallas``; the
kernel is ``csrc/reduce.cu`` (two stages, deterministic). On CPU tensors
the wrapper runs the plain-torch twin ``reduce_track`` (ops/track.py,
re-exported here as ``plain``); on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.track import TrackData
from slambench_tpu_torch.ops.track import reduce_track as plain

# Stage-1 blocks: one per SM of an H100 (132). Fixed, so the partials and
# their summation order do not depend on the input size.
NBLOCKS = 132

# Kernel launches since the last reset (chip_smoke.py reads this).
launches = 0


def reduce_track_cuda(data: TrackData) -> torch.Tensor:
    """Packed 32-float reduction of TrackData (ops.track contract)."""
    global launches
    result, error, J = data["result"], data["error"], data["J"]
    if result.dtype != torch.int32 or error.dtype != torch.float32 \
            or J.dtype != torch.float32:
        raise ValueError(f"dtypes must be int32/float32/float32, got "
                         f"{result.dtype}/{error.dtype}/{J.dtype}")
    if error.shape != result.shape or J.shape != (6, *result.shape):
        raise ValueError(f"shapes must be [h,w], [h,w], [6,h,w]; got "
                         f"{tuple(result.shape)}, {tuple(error.shape)}, "
                         f"{tuple(J.shape)}")
    devices = {result.device, error.device, J.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = result.device
    if device.type == "cpu":
        return plain(data)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not (result.is_contiguous() and error.is_contiguous()
            and J.is_contiguous()):
        raise ValueError("TrackData tensors must be contiguous")
    n = result.numel()
    partials = torch.empty((NBLOCKS, 32), dtype=torch.float32, device=device)
    out = torch.empty((32,), dtype=torch.float32, device=device)
    lib = build.load()
    status = lib.slb_reduce_track_f32(
        result.data_ptr(), error.data_ptr(), J.data_ptr(),
        partials.data_ptr(), out.data_ptr(), n, NBLOCKS,
        torch.cuda.current_stream(device).cuda_stream)
    build.check(status, "reduce kernel")
    launches += 1
    return out
