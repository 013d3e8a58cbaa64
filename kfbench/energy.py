"""The card's energy counter through NVML (a copy of the ctypes read in
``slambench_tpu_torch/utils/power.py:NvmlRail``):
``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded, from ``libnvidia-ml.so.1``, which the NVIDIA driver ships."""

from __future__ import annotations

import ctypes


class EnergyCounter:
    def __init__(self, index: int = 0,
                 library: str = "libnvidia-ml.so.1"):
        lib = ctypes.CDLL(library)
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        for fn in (lib.nvmlInit_v2, lib.nvmlDeviceGetHandleByIndex_v2,
                   lib.nvmlDeviceGetTotalEnergyConsumption):
            fn.restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(
            index, ctypes.pointer(self._handle)),
            "nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _check(status: int, what: str) -> None:
        if status != 0:
            raise RuntimeError(f"NVML: {what} returned {status}")

    def joules(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.pointer(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value * 1e-3
