"""Port parity for the gather kernels G1-G4 (ops/hopper/gather.py) and the
gather probe tools.

Each plain twin is held against the JAX expression that the Pallas gather
probes (slambench_tpu/tools/mosaic_probe.py P1-P3) or the XLA probes
compute, on the same numpy inputs from a seed. A gather copies, so the
tolerance is exact equality, and the uint16 path must equal ``mm2meters``
bit for bit. On the CPU the wrappers run their twins; the CUDA kernels
run only on a card (test_torch_cuda.py, ``python3 chip_smoke.py``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.ops.preprocess import mm2meters as j_mm2meters  # noqa: E402

from slambench_tpu_torch.ops.hopper import gather  # noqa: E402
from slambench_tpu_torch.ops.preprocess import mm2meters  # noqa: E402
from slambench_tpu_torch.tools import gather_probe, mosaic_probe  # noqa: E402

torch.set_num_threads(2)
RNG = np.random.default_rng(7)
ROWS, COLS = 256, 128                  # the P1 probe's table and index
H, W = 24, 32                          # a small depth image
TABLES = {
    "float32": RNG.random((ROWS, COLS)).astype(np.float32),
    "int16": RNG.integers(-32766, 32767, (ROWS, COLS)).astype(np.int16),
    "uint16": RNG.integers(0, 65535, (ROWS, COLS)).astype(np.uint16),
}


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _idx(hi, shape, lo=0):
    return RNG.integers(lo, hi, shape).astype(np.int32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(TABLES))
def test_flat_twin_matches_jnp_take(dtype):
    t, i = TABLES[dtype], _idx(ROWS * COLS, (ROWS, COLS))
    want = jnp.take(jnp.asarray(t).reshape(-1), jnp.asarray(i)) \
        .astype(jnp.float32)
    _eq(gather.gather_flat_plain(T(t), T(i)), want)


@pytest.mark.parametrize("mode,axis,hi", [("flat", None, ROWS * COLS),
                                          ("lane", 1, COLS),
                                          ("sublane", 0, ROWS)])
def test_axis_twin_matches_the_pallas_bodies(mode, axis, hi):
    """P1's three kernel bodies: take(t.ravel(), i), take_along_axis(t, i,
    axis=1) and axis=0."""
    t, i = TABLES["float32"], _idx(hi, (ROWS, COLS))
    jt, ji = jnp.asarray(t), jnp.asarray(i)
    want = (jnp.take(jt.reshape(-1), ji, axis=0) if axis is None
            else jnp.take_along_axis(jt, ji, axis=axis))
    _eq(gather.gather_axis_plain(T(t), T(i), mode), want)


def test_2d_twin_matches_jnp_advanced_index():
    """P3's kernel body: t[vi, ui]."""
    t = RNG.random((H, W)).astype(np.float32)
    vi, ui = _idx(H, (64, 32)), _idx(W, (64, 32))
    want = jnp.asarray(t)[jnp.asarray(vi), jnp.asarray(ui)]
    _eq(gather.gather_2d_plain(T(t), T(vi), T(ui)), want)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_clamp_twin_matches_jnp_clip_and_promise_in_bounds(dtype):
    """The XLA probes' modes: clip with indices below -n, in [-n, 0)
    (which JAX wraps NumPy-style before it clips), in range and at or
    above n; and promise_in_bounds with indices in range."""
    t = TABLES[dtype].reshape(-1)
    jt = jnp.asarray(t)
    pick = RNG.integers(0, 3, 4096)
    out_of_range = np.select(
        [pick == 0, pick == 1],
        [_idx(-t.size, (4096,), lo=-3 * t.size),
         _idx(0, (4096,), lo=-t.size)],
        _idx(t.size + 500, (4096,))).astype(np.int32)
    edges = [-t.size - 1, -t.size, -1, 0, t.size - 1, t.size,
             np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    out_of_range = np.concatenate([out_of_range, np.int32(edges)])
    assert (out_of_range < -t.size).any() and (out_of_range >= t.size).any()
    assert ((out_of_range < 0) & (out_of_range >= -t.size)).any()
    _eq(gather.gather_flat_plain(T(t), T(out_of_range), clamp=True),
        jt.at[jnp.asarray(out_of_range)].get(mode="clip").astype(jnp.float32))
    inside = _idx(t.size, (4096,))
    _eq(gather.gather_flat_plain(T(t), T(inside)),
        jt.at[jnp.asarray(inside)].get(mode="promise_in_bounds")
        .astype(jnp.float32))


def test_u16_twin_equals_mm2meters_bit_for_bit():
    mm = RNG.integers(0, 65535, (H, W)).astype(np.uint16)
    i = _idx(H * W, (4096,))
    got = gather.gather_u16_plain(T(mm), T(i))
    want = np.asarray(j_mm2meters(jnp.asarray(mm), 1)).reshape(-1)[i]
    _eq(got, want)
    # ... and G1 on the f32 metre image gives the same bits, whether the
    # image comes from the port's mm2meters (on the CPU) or mm_to_meters.
    _eq(gather.gather_flat_plain(mm2meters(T(mm), 1).contiguous(), T(i)),
        got.numpy())
    _eq(gather.gather_flat_plain(gather.mm_to_meters(T(mm)), T(i)),
        got.numpy())


def test_wrappers_take_their_twins_on_cpu_and_count_nothing():
    before = dict(gather.launches)
    t, i = T(TABLES["float32"]), T(_idx(COLS, (ROWS, COLS)))
    mm = T(TABLES["uint16"][:H, :W])
    flat_i = T(_idx(H * W, (100,)))
    vi, ui = T(_idx(ROWS, (50,))), T(_idx(COLS, (50,)))
    pairs = [
        (gather.gather_flat(t, i, clamp=True),
         gather.gather_flat_plain(t, i, clamp=True)),
        (gather.gather_axis_smem(t, i, "lane"),
         gather.gather_axis_plain(t, i, "lane")),
        (gather.gather_smem_u16(mm, flat_i), gather.gather_u16_plain(mm, flat_i)),
        (gather.gather_2d(t, vi, ui), gather.gather_2d_plain(t, vi, ui)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert gather.launches == before


REJECTS = {
    "index int64": (lambda: gather.gather_flat(
        T(TABLES["float32"]), torch.zeros(4, dtype=torch.int64)), "int32"),
    "table float64": (lambda: gather.gather_flat(
        T(TABLES["float32"]).double(), torch.zeros(4, dtype=torch.int32)),
        "table dtype"),
    "G2 table over shared memory": (lambda: gather.gather_axis_smem(
        torch.zeros(240, 320), torch.zeros(240, 320, dtype=torch.int32),
        "flat"), "shared memory"),
    "G2 lane rows differ": (lambda: gather.gather_axis_smem(
        T(TABLES["float32"]), torch.zeros(8, COLS, dtype=torch.int32),
        "lane"), "off the gathered axis"),
    "G2 unknown mode": (lambda: gather.gather_axis_smem(
        T(TABLES["float32"]), torch.zeros(ROWS, COLS, dtype=torch.int32),
        "diagonal"), "mode"),
    "G3 float32 table": (lambda: gather.gather_smem_u16(
        torch.zeros(H, W), torch.zeros(4, dtype=torch.int32)), "table dtype"),
    "G3 table over shared memory": (lambda: gather.gather_smem_u16(
        torch.zeros(400, 400, dtype=torch.uint16),
        torch.zeros(4, dtype=torch.int32)), "shared memory"),
    "G4 index shapes differ": (lambda: gather.gather_2d(
        torch.zeros(H, W), torch.zeros(4, dtype=torch.int32),
        torch.zeros(5, dtype=torch.int32)), "one shape"),
}


@pytest.mark.parametrize("case", list(REJECTS))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    call, match = REJECTS[case]
    with pytest.raises(ValueError, match=match):
        call()


TOOL_KEYS = {
    mosaic_probe: {"mosaic_take_flat", "take_flat_device",
                   "mosaic_take_along_lane", "mosaic_take_along_sublane",
                   "wide_gather_device", "wide_gather_smem_u16",
                   "adv2d_gather", "pallas_reduce", "pallas_bilateral",
                   *(f"gather_{t}_{m}_{c}" for t in ("small", "vol")
                     for m in ("clip", "pib") for c in ("77k", "16M"))},
    gather_probe: {"flat1d_f32", "op2d_f32", "flat1d_u16", "flat1d_u16_smem",
                   "vol_s16_77k", "tiny512_gather", "tiny512_onehot_mm",
                   "tiny512_iota_sum"},
}
ENTRY_KEYS = {"ok", "max_abs_err", "count", "bytes", "ops", "ns_per_elem",
              "plain_ns_per_elem", "library_ns_per_elem", "host_bound",
              "bound_ns_per_elem", "l2_resident"}
TIMINGS = ("ns_per_elem", "plain_ns_per_elem", "library_ns_per_elem",
           "host_bound")


@pytest.mark.parametrize("tool", [mosaic_probe, gather_probe],
                         ids=["mosaic_probe", "gather_probe"])
def test_probe_tool_on_cpu(tool, tmp_path, capsys):
    path = tmp_path / "out.json"
    assert tool.main(["--device", "cpu", "--n", "4096",
                      "--json", str(path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert json.loads(path.read_text()) == out
    assert out["device"] == "cpu"
    entries = {k: v for k, v in out.items() if isinstance(v, dict)}
    assert set(entries) == TOOL_KEYS[tool]
    for name, e in entries.items():
        assert ENTRY_KEYS <= set(e), name
        assert e["ok"] and e["max_abs_err"] == 0.0, name
        assert 0 < e["count"] <= 76_800 and e["bound_ns_per_elem"] > 0, name
        assert all(e[k] is None for k in TIMINGS), name
    if tool is mosaic_probe:
        assert entries["wide_gather_smem_u16"]["equals_device_f32"]


@pytest.mark.parametrize("tool", [mosaic_probe, gather_probe],
                         ids=["mosaic_probe", "gather_probe"])
def test_probe_tool_refuses_missing_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(["--device", "cuda"])
