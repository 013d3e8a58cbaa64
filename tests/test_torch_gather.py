"""Port parity for the gather kernels G1-G4 (ops/hopper/gather.py) and the
gather probe tools.

Each plain twin is held against the JAX expression that the Pallas gather
probes (slambench_tpu/tools/mosaic_probe.py P1-P3) or the XLA probes
compute, on the same numpy inputs from a seed; on out-of-range indices,
against the Pallas bodies themselves run by ``pl.pallas_call(...,
interpret=True)``. A gather copies, so the tolerance is exact equality
(NaN where the body gives NaN), and the uint16 path must equal
``mm2meters`` bit for bit. On the CPU the wrappers run their twins; the
CUDA kernels run only on a card (test_torch_cuda.py, ``python3
chip_smoke.py``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

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
    """Exact equality; NaN must stand where ``want`` has NaN."""
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _out_of_range(n, shape, rng):
    """Indices against ``n`` entries, drawn from every class: below -n,
    in [-n, 0), in range, at or above n, and the edges -n-1, -n, -1, 0,
    n-1, n and the int32 extremes."""
    edges = np.int64([-n - 1, -n, -1, 0, n - 1, n,
                      np.iinfo(np.int32).min, np.iinfo(np.int32).max])
    pick = rng.integers(0, 4, shape)
    idx = np.select([pick == 0, pick == 1, pick == 2],
                    [rng.integers(-3 * n - 1, -n, shape),
                     rng.integers(-n, 0, shape), rng.integers(0, n, shape)],
                    rng.integers(n, 3 * n + 1, shape))
    flat = idx.reshape(-1)
    flat[rng.choice(flat.size, edges.size, replace=False)] = edges
    return idx.astype(np.int32)


def _body(kernel, *args, shape, grid=(), in_specs=None, out_specs=None):
    """A Pallas body run as ``pl.pallas_call(..., interpret=True)``, as the
    JAX package's own tests run its kernels on the CPU."""
    kw = {} if in_specs is None else dict(grid=grid, in_specs=in_specs,
                                          out_specs=out_specs)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True, **kw)(*(jnp.asarray(a) for a in args)))


# P1's three bodies (probe_mosaic_gathers), as the JAX probe writes them.
P1_BODIES = {
    "flat": lambda t, i, o: o.__setitem__(
        slice(None), jnp.take(t[:].reshape(-1), i[:], axis=0)),
    "lane": lambda t, i, o: o.__setitem__(
        slice(None), jnp.take_along_axis(t[:], i[:], axis=1)),
    "sublane": lambda t, i, o: o.__setitem__(
        slice(None), jnp.take_along_axis(t[:], i[:], axis=0)),
}
OOR_ROWS, OOR_COLS = 12, 16             # small tables for the bodies


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


@pytest.mark.parametrize("mode,n", [("flat", OOR_ROWS * OOR_COLS),
                                    ("lane", OOR_COLS),
                                    ("sublane", OOR_ROWS)])
def test_p1_twins_match_the_pallas_bodies_out_of_range(mode, n):
    """P1's bodies in interpret mode wrap an index in [-n, 0) along the
    gathered axis and give NaN beyond it; G2's twin (and its wrapper on
    the CPU) in every mode, and G1's "fill" twin for the flat form."""
    rng = np.random.default_rng(31)
    t = rng.random((OOR_ROWS, OOR_COLS)).astype(np.float32)
    i = _out_of_range(n, (OOR_ROWS, OOR_COLS), rng)
    want = _body(P1_BODIES[mode], t, i, shape=i.shape)
    assert np.isnan(want).any() and not np.isnan(want).all()
    _eq(gather.gather_axis_plain(T(t), T(i), mode), want)
    _eq(gather.gather_axis_smem(T(t), T(i), mode), want)
    if mode == "flat":
        _eq(gather.gather_flat_plain(T(t), T(i), mode="fill"), want)


def test_p2_twins_match_the_pallas_body_out_of_range():
    """P2's body (a lane gather on the sublane-broadcast flat image, on a
    grid of [8, L] index blocks): G1's "fill" twin on the f32 metre image
    and G3's twin on the uint16 millimetre image both give its wrap and
    its NaN, and equal each other bit for bit."""
    rng = np.random.default_rng(32)
    h, w, lanes, steps = 6, 10, 16, 2
    mm = rng.integers(0, 65535, (h, w)).astype(np.uint16)
    depth = np.asarray(j_mm2meters(jnp.asarray(mm), 1))
    idx = _out_of_range(h * w, (8 * steps, lanes), rng)

    def wide_kernel(t_ref, i_ref, o_ref):
        t8 = jnp.broadcast_to(t_ref[:].reshape(1, h * w), (8, h * w))
        o_ref[:] = jnp.take_along_axis(t8, i_ref[:], axis=1)

    want = _body(wide_kernel, depth, idx, shape=idx.shape, grid=(steps,),
                 in_specs=[pl.BlockSpec((h, w), lambda s: (0, 0)),
                           pl.BlockSpec((8, lanes), lambda s: (s, 0))],
                 out_specs=pl.BlockSpec((8, lanes), lambda s: (s, 0)))
    assert np.isnan(want).any() and not np.isnan(want).all()
    _eq(gather.gather_flat_plain(T(depth), T(idx), mode="fill"), want)
    _eq(gather.gather_flat(T(depth), T(idx), mode="fill"), want)
    _eq(gather.gather_u16_plain(T(mm), T(idx)), want)
    _eq(gather.gather_smem_u16(T(mm), T(idx)), want)


def test_p3_twin_matches_the_pallas_body_out_of_range():
    """P3's body ``t[vi, ui]`` wraps each axis's index from [-n, 0) and
    then clips it: G4's twin (and its wrapper on the CPU) on both axes."""
    rng = np.random.default_rng(33)
    h, w, lanes, steps = 7, 5, 16, 2
    t = rng.random((h, w)).astype(np.float32)
    vi = _out_of_range(h, (8 * steps, lanes), rng)
    ui = _out_of_range(w, (8 * steps, lanes), rng)

    def adv_kernel(t_ref, vi_ref, ui_ref, o_ref):
        o_ref[:] = t_ref[:][vi_ref[:], ui_ref[:]]

    block = pl.BlockSpec((8, lanes), lambda s: (s, 0))
    want = _body(adv_kernel, t, vi, ui, shape=vi.shape, grid=(steps,),
                 in_specs=[pl.BlockSpec((h, w), lambda s: (0, 0)), block,
                           block], out_specs=block)
    _eq(gather.gather_2d_plain(T(t), T(vi), T(ui)), want)
    _eq(gather.gather_2d(T(t), T(vi), T(ui)), want)
    # In range, the twin is still the plain advanced index.
    _eq(gather.gather_2d_plain(T(t), T(vi % h), T(ui % w)), t[vi % h, ui % w])


@pytest.mark.parametrize("entries,staged", [
    (1, True), (gather.SHARE_FLOATS, True), (gather.SHARE_FLOATS + 1, True),
    (240 * 320, True), (302 * 384, True), (gather.G4_STAGED_MAX_ENTRIES, True),
    (gather.G4_STAGED_MAX_ENTRIES + 1, False), (454 * 384, False),
    (640 * 480, False), (720 * 1280, False)])
def test_g4_route_depends_on_the_table_size_alone(entries, staged):
    """The staged route (every block stages what it can hold, a multiple
    of 4 floats with the 8-byte mbarrier behind, and reads the rest from
    device memory) while a block holds at least half the table; the
    device-memory route beyond."""
    assert 4 * gather.SHARE_FLOATS + 8 <= gather.MAX_SMEM_BYTES \
        < 4 * (gather.SHARE_FLOATS + 4) + 8
    assert gather.g4_staged(entries) == staged
    assert (entries <= 2 * gather.SHARE_FLOATS) == staged


def test_sweep_builds_the_lost_designs_apart_from_the_library():
    """The G3/G4 designs that lost live in tools/gather_variants.cu, which
    the sweep appends to every copy of csrc/gather.cu; the shipped source
    holds none of them, and every one-place change finds its anchor."""
    from slambench_tpu_torch.tools import gather_sweep
    with open(gather_sweep.SOURCE) as f:
        shipped = f.read()
    with open(gather_sweep.LOST) as f:
        lost = f.read()
    for entry in ("slb_sweep_g3", "slb_sweep_cluster",
                  ".multicast::cluster"):
        assert entry in lost and entry not in shipped
    for changes, _ in gather_sweep.VARIANTS.values():
        src = gather_sweep.variant_source(changes)
        assert src.endswith(lost)
        assert (src == shipped + "\n" + lost) == (not changes)


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
    "G1 unknown mode": (lambda: gather.gather_flat(
        T(TABLES["float32"]), torch.zeros(4, dtype=torch.int32),
        mode="wrap"), "mode"),
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
    gather_probe: {"flat1d_f32", "op2d_f32", "op2d_f32_720p", "flat1d_u16",
                   "flat1d_u16_smem",
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
