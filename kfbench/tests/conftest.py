"""Shared pieces of the harness's CPU tests: a small deployment (the
traj2 configuration at 160x120 and 128^3) and its cell."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_setting(width: int = 160, volume: int = 128) -> dict:
    cfg = json.loads((ROOT / "kfbench/configs/traj2_256.json").read_text())
    s = width / 640
    cfg.update(input_size=[width, width * 3 // 4], compute_size_ratio=1,
               camera=[481.2 * s, 480.0 * s, 320.0 * s, 240.0 * s],
               volume_resolution=[volume] * 3)
    return cfg


def cell_limits(mix: str) -> dict:
    """The committed limits of ``traj2_256.<mix>``: the small runs are
    held to the cell's own."""
    return json.loads((ROOT / f"kfbench/limits/traj2_256.{mix}.json")
                      .read_text())


def small_cell(mix: str = "offline", **kw) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = f"traj2_256.{mix}"
    listed = [m for m in bench["end_to_end"]
              if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in bench["per_layer"]
             if "workloads" not in m or name in m["workloads"]]
    return {"name": f"small.{mix}", "chips": 1,
            "config": small_setting(**kw),
            "traffic": json.loads(
                (ROOT / f"kfbench/traffic/{mix}.json").read_text()),
            "limits": cell_limits(mix), "end_to_end": listed,
            "per_layer": layer}


@pytest.fixture
def cell():
    return small_cell
