"""Platform and device selection, the kernel build directory and the
failure -> remedy table (port of ``slambench_tpu/utils/backend.py``).

The reference's OpenCL host runtime (common_opencl.cpp:31-183),
capability by capability:

* ``OPENCL_PLATFORM`` / ``OPENCL_DEVICE`` (common_opencl.cpp:46-88) ->
  ``SLAMBENCH_PLATFORM`` (``cpu``, or ``gpu`` / ``cuda`` for the card)
  and ``SLAMBENCH_DEVICE`` (the card's ordinal: ``cuda:N``, made the
  current CUDA device);
* the runtime kernel build and its cache (common_opencl.cpp:95-150) ->
  the nvcc build of ``ops/hopper/build.py`` and the g++ build of
  ``io/native.py``, which build under ``SLAMBENCH_JIT_CACHE`` when it
  names a directory (``build.py:build_dir``; by default each stays in
  its ignored ``_build/``);
* the device report (common_opencl.cpp:58-66) -> ``device_report``
  (``policy.py``'s);
* ``clGetErrorString`` (common_opencl.cpp:153-183) -> ``explain_error``,
  a failure -> remedy table for the port's failures.

An explicit ``--device`` wins over both variables. Unlike JAX's
``select_device``, which warns and keeps the default device, a
malformed or out-of-range ``SLAMBENCH_DEVICE`` raises, as does any
``SLAMBENCH_PLATFORM`` but ``cpu``, ``gpu`` and ``cuda``: the error
names the variable.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from slambench_tpu_torch.policy import device_report  # noqa: F401

PLATFORM_ENV = "SLAMBENCH_PLATFORM"
DEVICE_ENV = "SLAMBENCH_DEVICE"

# Failure signature -> remedy, first match wins (the clGetErrorString
# analogue).
ERROR_HINTS = (
    ("CUDA out of memory",
     "device memory exhausted — lower --volume-resolution, raise "
     "--compute-size-ratio, or shard the volume with --mesh z:N"),
    ("torch.cuda.is_available() is False",
     "no usable CUDA card — pass --device cpu or set "
     "SLAMBENCH_PLATFORM=cpu to run the plain-torch path on the CPU"),
    ("No CUDA GPUs are available",
     "no usable CUDA card — pass --device cpu or set "
     "SLAMBENCH_PLATFORM=cpu to run the plain-torch path on the CPU"),
    ("nvcc not found",
     "the Hopper kernels are built with nvcc at first use — set "
     "CUDA_HOME to the CUDA toolkit (its bin/nvcc) or put nvcc on $PATH"),
    ("nvcc failed",
     "the Hopper kernels did not build (the compiler's output is in the "
     "error) — they need a CUDA 12 nvcc for sm_90a; clear the build "
     "directory (ops/hopper/_build or $SLAMBENCH_JIT_CACHE) after a "
     "toolkit change"),
    (DEVICE_ENV,
     "SLAMBENCH_DEVICE is a card ordinal below torch.cuda.device_count(); "
     "unset it to use card 0"),
    (PLATFORM_ENV,
     "SLAMBENCH_PLATFORM is cpu, gpu or cuda; unset it to use the card"),
    ("NaN", "--debug-nans faults on the producing op; tracking NaNs "
     "usually mean an empty/degenerate depth frame"),
)


def select_backend() -> Optional[str]:
    """``"cpu"`` or ``"cuda"`` from ``SLAMBENCH_PLATFORM``; None when it
    is unset. Any other value (``tpu`` among them) raises."""
    value = os.environ.get(PLATFORM_ENV)
    if not value:
        return None
    platform = value.strip().lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("gpu", "cuda"):
        return "cuda"
    raise ValueError(f"{PLATFORM_ENV}={value!r}: the port runs on cpu or "
                     "on the CUDA card (gpu / cuda)")


def _ordinal(value: str) -> int:
    try:
        idx = int(value)
    except ValueError:
        raise ValueError(f"{DEVICE_ENV}={value!r} is not a device ordinal"
                         ) from None
    if idx < 0:
        raise ValueError(f"{DEVICE_ENV}={value!r} is not a device ordinal")
    return idx


def select_device() -> Optional[torch.device]:
    """``cuda:N`` from ``SLAMBENCH_DEVICE=N``, made the current CUDA
    device (JAX's ``jax_default_device``); None when it is unset. A
    value that is no ordinal, or no card's, raises."""
    value = os.environ.get(DEVICE_ENV)
    if not value:
        return None
    idx = _ordinal(value)
    count = torch.cuda.device_count()
    if idx >= count:
        raise ValueError(f"{DEVICE_ENV}={idx} out of range: "
                         f"{count} CUDA device(s)")
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def device_name(explicit: Optional[str] = None) -> str:
    """The device an entry point runs on: ``explicit`` (its ``--device``)
    when given, else the environment's platform and ordinal, else
    ``cuda``. With ``SLAMBENCH_PLATFORM=cpu`` only ordinal 0 (the one
    CPU device) may be set."""
    if explicit:
        return explicit
    if select_backend() == "cpu":
        value = os.environ.get(DEVICE_ENV)
        if value and _ordinal(value) != 0:
            raise ValueError(f"{DEVICE_ENV}={value!r} with "
                             f"{PLATFORM_ENV}=cpu: the CPU is device 0")
        return "cpu"
    device = select_device()
    return "cuda" if device is None else str(device)


def explain_error(exc: BaseException) -> Optional[str]:
    """The remedy for a known failure signature, else None."""
    msg = f"{type(exc).__name__}: {exc}"
    for needle, hint in ERROR_HINTS:
        if needle in msg:
            return hint
    return None
