"""Port parity for ``--stats``: ``utils/perfstats.py`` and
``utils/power.py`` against the JAX package's on test_power.py's fixture
sysfs trees, ``tools/process_power_rpt.py``, the card's NVML sensor
against a fake library, and the CLI's refusal to run ``--stats`` on
``cuda`` without NVML."""

import io
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu.tools import process_power_rpt as jrpt  # noqa: E402
from slambench_tpu.utils import perfstats as jperf  # noqa: E402
from slambench_tpu.utils import power as jpower  # noqa: E402

from slambench_tpu_torch.frontend import benchmark  # noqa: E402
from slambench_tpu_torch.io.raw import RawWriter  # noqa: E402
from slambench_tpu_torch.tools import process_power_rpt as trpt  # noqa: E402
from slambench_tpu_torch.utils import perfstats as tperf  # noqa: E402
from slambench_tpu_torch.utils import power as tpower  # noqa: E402


def _odroid(tmp_path):
    rails = {}
    for name, watts in (("a15", 1.25), ("gpu", 0.5)):
        d = tmp_path / f"INA231_{name}"
        d.mkdir()
        (d / "sensor_W").write_text(f"{watts}\n")
        rails[name] = str(d / "sensor_W")
    return dict(odroid_nodes=rails, rapl_root=str(tmp_path / "no"),
                hwmon_root=str(tmp_path / "no"))


def _hwmon(tmp_path):
    chip = tmp_path / "hwmon0"
    chip.mkdir()
    (chip / "name").write_text("board\n")
    (chip / "power1_input").write_text("12500000\n")
    (chip / "power1_label").write_text("cpu_rail\n")
    (chip / "power2_input").write_text("3000000\n")
    chip1 = tmp_path / "hwmon1"
    chip1.mkdir()
    (chip1 / "name").write_text("board\n")
    (chip1 / "power1_input").write_text("1000000\n")
    (chip1 / "power1_label").write_text("cpu_rail\n")
    return dict(odroid_nodes={}, rapl_root=str(tmp_path / "no"),
                hwmon_root=str(tmp_path))


def _priority(tmp_path):
    kw = _hwmon(tmp_path)
    d = tmp_path / "ina"
    d.mkdir()
    (d / "sensor_W").write_text("1.0\n")
    kw["odroid_nodes"] = {"a15": str(d / "sensor_W")}
    return kw


def _dummy(tmp_path):
    return dict(odroid_nodes={}, rapl_root=str(tmp_path / "no"),
                hwmon_root=str(tmp_path / "no"))


def _rails(pm):
    return {k: pm.power_stats.get(k) for k in pm.power_stats.keys
            if k != "sample_t"}


@pytest.mark.parametrize("tree,sensor", [(_odroid, "odroid"),
                                         (_hwmon, "hwmon"),
                                         (_priority, "odroid"),
                                         (_dummy, "dummy")])
def test_monitor_matches_jax_on_fixture_tree(tmp_path, tree, sensor):
    kw = tree(tmp_path)
    pt, pj = tpower.PowerMonitor(**kw), jpower.PowerMonitor(**kw)
    assert pt.sensor.value == pj.sensor.value == sensor
    assert pt.is_active() == pj.is_active() == (sensor != "dummy")
    for pm in (pt, pj):
        pm.start()
        pm.sample()
        pm.sample()
    assert _rails(pt) == _rails(pj)
    assert len(pt.power_stats.get("sample_t")) == 2


@pytest.mark.parametrize("after_uj,expect_sample", [(1500000, True),
                                                    (500, False)])
def test_rapl_matches_jax(tmp_path, after_uj, expect_sample):
    """Power from the energy counter's advance; a counter that wraps
    backwards gives no sample, in both packages."""
    zone = tmp_path / "intel-rapl:0"
    zone.mkdir()
    (zone / "name").write_text("package-0\n")
    (zone / "energy_uj").write_text("1000000\n")
    kw = dict(odroid_nodes={}, rapl_root=str(tmp_path),
              hwmon_root=str(tmp_path / "no"))
    pt, pj = tpower.PowerMonitor(**kw), jpower.PowerMonitor(**kw)
    assert pt.sensor.value == pj.sensor.value == "rapl"
    pt.start()
    pj.start()
    time.sleep(0.02)
    (zone / "energy_uj").write_text(f"{after_uj}\n")
    pt.sample()
    pj.sample()
    st, sj = (pm.power_stats.get("Power_package-0") for pm in (pt, pj))
    assert len(st) == len(sj) == int(expect_sample)
    for s in (st, sj):
        if s:
            assert 0.5 / 10.0 < s[0] < 0.5 / 0.02 * 1.1


def test_total_energy_matches_jax(tmp_path):
    series = ((10.0, 2.0), (11.0, 2.0), (12.5, 3.0))
    monitors = (tpower.PowerMonitor(**_dummy(tmp_path)),
                jpower.PowerMonitor(**_dummy(tmp_path)))
    for pm, st in zip(monitors, (tperf.StatType, jperf.StatType)):
        for t, w in series:
            pm.power_stats.sample("sample_t", t, st.TIME)
            pm.power_stats.sample("Power_x", w, st.POWER)
    for label in (None, "Power_x", "nope"):
        assert monitors[0].total_energy(label) == pytest.approx(
            monitors[1].total_energy(label))
    assert monitors[0].total_energy() == pytest.approx(6.5)


def test_process_power_rpt_matches_jax(tmp_path, capsys):
    rpt = tmp_path / "power.rpt"
    rpt.write_text("t railA railB\n0.0 2.0 0.0\n1.0 2.0 2.0\n2.0 2.0 4.0\n")
    got = trpt.integrate_report(str(rpt))
    assert got == jrpt.integrate_report(str(rpt))
    assert got["railA"] == pytest.approx(4.0)
    assert got["railB"] == pytest.approx(4.0)
    assert trpt.main([str(rpt)]) == 0
    assert "TOTAL" in capsys.readouterr().out
    assert trpt.main([]) == 1


def test_perfstats_series_and_summary_match_jax():
    outs = []
    for mod in (tperf, jperf):
        ps = mod.PerfStats()
        for i in range(5):
            ps.sample("tracking", 0.01 * (i + 1), mod.StatType.TIME)
            ps.sample("X", float(i), mod.StatType.DISTANCE)
        assert ps.keys == ["tracking", "X"]
        assert ps.last("tracking") == 0.05
        assert abs(ps.mean("tracking") - 0.03) < 1e-12
        out = io.StringIO()
        ps.print_header(out)
        ps.print_row(out)
        ps.print_all_data(out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "tracking" in outs[0] and "mean" in outs[0]
    assert isinstance(tperf.Stats, tperf.PerfStats)


class FakeNvml:
    """The four NVML entry points, writing through ctypes pointers as
    ``libnvidia-ml.so.1`` does: 250 W, 1.5 J per energy read."""

    def __init__(self, init_status=0):
        self.init_status = init_status
        self.energy_mj = 10_000_000

    def nvmlInit_v2(self):
        return self.init_status

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle.contents.value = 0x1000 + index
        return 0 if index < 2 else 2

    def nvmlDeviceGetPowerUsage(self, handle, mw):
        assert handle.value == 0x1001
        mw.contents.value = 250_000
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, mj):
        self.energy_mj += 1500
        mj.contents.value = self.energy_mj
        return 0


def test_nvml_sensor_against_fake_library(tmp_path):
    """The card's rail: watts from mW, joules per sample interval from
    the mJ counter; the counter, not integrated power, gives the total.
    The host sensors are not probed."""
    kw = _odroid(tmp_path)
    pm = tpower.PowerMonitor(**kw, nvml_library=FakeNvml(), nvml_index=1)
    assert pm.sensor == tpower.SensorType.NVML and pm.is_active()
    assert pm.nvml_rail == "gpu1"
    pm.start()
    for _ in range(3):
        pm.sample()
    assert pm.power_stats.get("Power_gpu1") == [250.0] * 3
    np.testing.assert_allclose(pm.power_stats.get("Energy_gpu1"), [1.5] * 3)
    assert pm.total_energy() == pytest.approx(4.5)
    assert pm.total_energy("gpu1") == pytest.approx(4.5)
    assert "Power_a15" not in pm.power_stats.keys
    text = io.StringIO()
    pm.power_stats.print_all_data(text)
    assert "Power_gpu1" in text.getvalue() and "Energy_gpu1" in text.getvalue()


def test_nvml_failures_raise(tmp_path):
    with pytest.raises(RuntimeError, match="nvmlInit_v2 returned 9"):
        tpower.PowerMonitor(nvml_library=FakeNvml(init_status=9))
    with pytest.raises(RuntimeError, match="HandleByIndex"):
        tpower.PowerMonitor(nvml_library=FakeNvml(), nvml_index=5)
    with pytest.raises(RuntimeError, match="cannot load"):
        tpower.PowerMonitor(nvml_library=str(tmp_path / "libnvidia-ml.so.1"))


def test_stats_on_cuda_without_nvml_exits_nonzero(tmp_path, monkeypatch,
                                                  capsys):
    """The CLI on a (pretended) card whose NVML does not load exits 1
    before it touches the device, instead of sampling DUMMY."""
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        w.write(np.zeros((12, 16), np.uint16))
    monkeypatch.setattr(benchmark, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(tpower, "NVML_LIBRARY",
                        str(tmp_path / "libnvidia-ml.so.1"))
    with pytest.raises(SystemExit) as exc:
        benchmark.main(["--stats", "-i", path, "-o",
                        str(tmp_path / "b.log")])
    assert exc.value.code == 1
    assert "needs the card's power rail" in capsys.readouterr().err
