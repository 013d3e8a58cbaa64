"""Power and energy monitoring (a copy of ``slambench_tpu/utils/power.py``
with one more sensor: the card's own rail through NVML).

Re-implementation of the reference PowerMonitor
(reference: kfusion/src/PowerMonitor.cpp, include/PowerMonitor.h): probes
platform sensors in priority order and samples them into its own
PerfStats. Sensor backends:

* ODROID INA231 sysfs nodes (A7/A15/GPU/DRAM rails,
  reference: PowerMonitor.cpp:188-221) — kept for interface parity;
* Intel RAPL via powercap sysfs (the PAPI path of the reference,
  reference: PowerMonitor.cpp:225-474, reads the same MSR-backed
  counters without requiring PAPI);
* generic Linux hwmon power rails (``/sys/class/hwmon/*/power*_input``,
  microwatts) — covers server boards/BMCs that expose instantaneous
  power without RAPL;
* NVML — the CUDA card's board power (``nvmlDeviceGetPowerUsage``, mW)
  and its energy counter (``nvmlDeviceGetTotalEnergyConsumption``, mJ),
  read through ``ctypes`` from ``libnvidia-ml.so.1`` (installed with
  the NVIDIA kernel module, so no Python package is needed). The
  reference samples the accelerator's own rail (the ODROID ``gpu``
  node); this is that rail on a data-centre card. It is probed only
  when the caller names the library, and then it must load: a run on
  the card never falls back to the host sensors or to DUMMY;
* DUMMY — no sensors, sampling is a no-op (reference:
  PowerMonitor.cpp:87-89,138-143).

The sysfs roots, the NVML library and the card's index are
constructor-injectable so each backend is testable against a fixture
tree or a fake library (tests/test_power.py, tests/test_torch_stats.py).
"""

from __future__ import annotations

import ctypes
import glob
import os
import time
from enum import Enum
from typing import Dict, Optional, Union

from slambench_tpu_torch.utils.perfstats import PerfStats, StatType


class SensorType(Enum):
    ODROID = "odroid"
    RAPL = "rapl"
    HWMON = "hwmon"
    NVML = "nvml"
    DUMMY = "dummy"


_ODROID_NODES = {
    # name -> sysfs glob (reference: PowerMonitor.cpp:188-221)
    "a15": "/sys/bus/i2c/drivers/INA231/*0040/sensor_W",
    "a7": "/sys/bus/i2c/drivers/INA231/*0045/sensor_W",
    "gpu": "/sys/bus/i2c/drivers/INA231/*0044/sensor_W",
    "mem": "/sys/bus/i2c/drivers/INA231/*0041/sensor_W",
}

_RAPL_ROOT = "/sys/class/powercap"
_HWMON_ROOT = "/sys/class/hwmon"
# The NVML library that comes with the NVIDIA kernel module.
NVML_LIBRARY = "libnvidia-ml.so.1"


class NvmlRail:
    """One CUDA card's power rail through NVML.

    ``library`` is a path for ``ctypes.CDLL`` or an object with the four
    NVML entry points (a test's fake). Every call's return code is
    checked; any failure raises ``RuntimeError``."""

    def __init__(self, library: Union[str, object] = NVML_LIBRARY,
                 index: int = 0):
        if isinstance(library, str):
            try:
                lib = ctypes.CDLL(library)
            except OSError as exc:
                raise RuntimeError(f"NVML: cannot load {library}: {exc}") \
                    from exc
            lib.nvmlInit_v2.argtypes = []
            lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
                ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
            lib.nvmlDeviceGetPowerUsage.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
            lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
            for fn in (lib.nvmlInit_v2, lib.nvmlDeviceGetHandleByIndex_v2,
                       lib.nvmlDeviceGetPowerUsage,
                       lib.nvmlDeviceGetTotalEnergyConsumption):
                fn.restype = ctypes.c_int
        else:
            lib = library
        self._lib = lib
        self.index = int(index)
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(
            self.index, ctypes.pointer(self._handle)),
            "nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _check(status: int, what: str) -> None:
        if status != 0:
            raise RuntimeError(f"NVML: {what} returned {status}")

    def power_w(self) -> float:
        """Board power now, in watts."""
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetPowerUsage(
            self._handle, ctypes.pointer(mw)), "nvmlDeviceGetPowerUsage")
        return mw.value * 1e-3

    def energy_j(self) -> float:
        """The card's energy counter, in joules."""
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.pointer(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value * 1e-3


class PowerMonitor:
    def __init__(self,
                 odroid_nodes: Optional[Dict[str, str]] = None,
                 rapl_root: str = _RAPL_ROOT,
                 hwmon_root: str = _HWMON_ROOT,
                 nvml_library: Union[str, object, None] = None,
                 nvml_index: int = 0):
        """``nvml_library`` (a path or a fake library object) asks for
        the card's rail: it raises ``RuntimeError`` if NVML fails, and
        the host sensors are not probed. Without it the probe order is
        the JAX package's."""
        self.power_stats = PerfStats()
        self._odroid: Dict[str, str] = {}
        self._rapl: Dict[str, str] = {}
        self._hwmon: Dict[str, str] = {}
        self._rapl_last: Dict[str, tuple] = {}
        self._nvml: Optional[NvmlRail] = None
        self._nvml_last = 0.0

        if nvml_library is not None:
            self._nvml = NvmlRail(nvml_library, nvml_index)
            self.sensor = SensorType.NVML
            return
        for name, pattern in (odroid_nodes or _ODROID_NODES).items():
            hits = glob.glob(pattern)
            if hits:
                self._odroid[name] = hits[0]
        if not self._odroid:
            for zone in sorted(glob.glob(os.path.join(
                    rapl_root, "intel-rapl:*"))):
                name_file = os.path.join(zone, "name")
                energy_file = os.path.join(zone, "energy_uj")
                if os.path.exists(name_file) and os.access(energy_file,
                                                           os.R_OK):
                    try:
                        label = open(name_file).read().strip()
                        int(open(energy_file).read().strip())
                    except (OSError, ValueError):
                        continue
                    self._rapl[label] = energy_file
        if not self._odroid and not self._rapl:
            for chip in sorted(glob.glob(os.path.join(hwmon_root,
                                                      "hwmon*"))):
                try:
                    chip_name = open(os.path.join(chip,
                                                  "name")).read().strip()
                except OSError:
                    chip_name = os.path.basename(chip)
                for node in sorted(glob.glob(os.path.join(
                        chip, "power*_input"))):
                    try:
                        int(open(node).read().strip())
                    except (OSError, ValueError):
                        continue
                    rail = os.path.basename(node)[: -len("_input")]
                    label_file = os.path.join(chip, rail + "_label")
                    if os.path.exists(label_file):
                        try:
                            rail = open(label_file).read().strip()
                        except OSError:
                            pass
                    # Disambiguate colliding keys (two chips with the
                    # same name, or two rails sharing a label on one
                    # chip) — a dict overwrite would silently drop a
                    # rail from every sample and under-report energy.
                    key = f"{chip_name}_{rail}"
                    if key in self._hwmon:
                        key = f"{key}_{os.path.basename(chip)}_" \
                              f"{os.path.basename(node)[:-len('_input')]}"
                    self._hwmon[key] = node

        if self._odroid:
            self.sensor = SensorType.ODROID
        elif self._rapl:
            self.sensor = SensorType.RAPL
        elif self._hwmon:
            self.sensor = SensorType.HWMON
        else:
            self.sensor = SensorType.DUMMY

    def is_active(self) -> bool:
        return self.sensor != SensorType.DUMMY

    @property
    def nvml_rail(self) -> str:
        """The card rail's series suffix: ``Power_<rail>``,
        ``Energy_<rail>``."""
        return f"gpu{self._nvml.index}" if self._nvml else ""

    def start(self) -> None:
        self.power_stats.start()
        if self.sensor == SensorType.NVML:
            self._nvml_last = self._nvml.energy_j()
        if self.sensor == SensorType.RAPL:
            now = time.monotonic()
            for label, path in self._rapl.items():
                try:
                    self._rapl_last[label] = (
                        int(open(path).read().strip()), now)
                except (OSError, ValueError):
                    pass

    def sample(self) -> None:
        """Sample all rails into power_stats
        (reference: PowerMonitor.cpp:114-145)."""
        # Record the sample timestamp so total_energy can integrate
        # watts over real intervals (the reference integrates its
        # power.rpt the same way, thirdparty/processPowerRpt).
        self.power_stats.sample("sample_t", time.monotonic(),
                                StatType.TIME)
        if self.sensor == SensorType.ODROID:
            for name, path in self._odroid.items():
                try:
                    w = float(open(path).read().strip())
                except (OSError, ValueError):
                    continue
                self.power_stats.sample("Power_" + name, w, StatType.POWER)
        elif self.sensor == SensorType.RAPL:
            now = time.monotonic()
            for label, path in self._rapl.items():
                try:
                    uj = int(open(path).read().strip())
                except (OSError, ValueError):
                    continue
                prev = self._rapl_last.get(label)
                self._rapl_last[label] = (uj, now)
                if prev is None or now <= prev[1]:
                    continue
                duj = uj - prev[0]
                if duj < 0:     # counter wrap
                    continue
                watts = (duj * 1e-6) / (now - prev[1])
                self.power_stats.sample("Power_" + label, watts,
                                        StatType.POWER)
        elif self.sensor == SensorType.HWMON:
            for name, path in self._hwmon.items():
                try:
                    uw = int(open(path).read().strip())
                except (OSError, ValueError):
                    continue
                self.power_stats.sample("Power_" + name, uw * 1e-6,
                                        StatType.POWER)
        elif self.sensor == SensorType.NVML:
            # Board power now, and the energy counter's advance since
            # the last sample (or ``start``): joules per sample interval.
            rail = self.nvml_rail
            self.power_stats.sample("Power_" + rail, self._nvml.power_w(),
                                    StatType.POWER)
            joules = self._nvml.energy_j()
            self.power_stats.sample("Energy_" + rail,
                                    joules - self._nvml_last,
                                    StatType.ENERGY)
            self._nvml_last = joules
        # DUMMY: no-op.

    def total_energy(self, label: Optional[str] = None) -> float:
        """Integrated energy (J) from the sampled power series: right-
        endpoint rectangle rule against the sample_t timestamps recorded
        by ``sample()`` (reference: processPowerRpt integrates the
        power.rpt columns the same way). A rail with an energy counter
        (NVML's ``Energy_<rail>``, joules per sample interval) reports
        the counter's sum instead of its integrated power."""
        total = 0.0
        times = self.power_stats.get("sample_t")
        keys = self.power_stats.keys
        for key in keys:
            if key == "sample_t" or (label and label not in key):
                continue
            if key.startswith("Energy_"):
                total += sum(self.power_stats.get(key))
                continue
            if "Energy_" + key[len("Power_"):] in keys:
                continue
            samples = self.power_stats.get(key)
            if len(times) == len(samples) and len(samples) > 1:
                for i in range(1, len(samples)):
                    total += samples[i] * (times[i] - times[i - 1])
        return total
