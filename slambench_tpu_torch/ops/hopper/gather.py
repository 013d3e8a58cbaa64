"""G1-G4 wrappers: table gathers as hand-written CUDA kernels.

The kernels (``csrc/gather.cu``) are the Hopper counterparts of the three
Pallas gather probes in ``slambench_tpu/tools/mosaic_probe.py`` (P1-P3)
and serve the port's gather probes (``tools/mosaic_probe.py``,
``tools/gather_probe.py``):

* G1 ``gather_flat``: ``out = table.ravel()[idx]`` from device memory,
  f32 / int16 / uint16 tables widened to f32, several lookups a thread,
  in one of JAX's gather modes: ``"promise_in_bounds"`` (the indices
  must be in range), ``"clip"`` (an index in ``[-n, 0)`` first becomes
  ``idx + n``, NumPy-style, then the index is clipped to ``[0, n - 1]``)
  or ``"fill"`` (the same wrap, and NaN for any other index outside the
  table: what ``take`` and ``take_along_axis`` do by default, so what
  P1's flat body and P2 compute);
* G2 ``gather_axis_smem``: a flat, lane (``axis=1``) or sublane
  (``axis=0``) gather from an f32 table staged in shared memory, in
  mode ``"fill"`` along the gathered axis: each block stages only what
  its outputs read (flat: a share of the table per block of a
  thread-block cluster, read across the cluster);
* G3 ``gather_smem_u16``: the uint16 millimetre image staged in shared
  memory by TMA, in mode ``"fill"``, each lookup converted to metres by
  IEEE division, as the JAX package's ``mm2meters``
  (``ops/preprocess.py:mm_to_meters``);
* G4 ``gather_2d``: ``out = table[vi, ui]``, each index wrapped from
  ``[-n, 0)`` and clipped to its axis, as P3's body computes it; with as
  much of the table as a block holds staged in every block and the rest
  read from device memory, or, for a table of which a block would hold
  less than half, all from device memory (``g4_staged``).

Each has a plain twin here (``*_plain``): the one PyTorch indexing call
that computes the same gather, plus the widening, wrapping and NaN glue
its contract needs. A wrapper runs the twin only for CPU tensors; for
CUDA tensors it launches its kernel or raises. Indices are int32 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.preprocess import mm_to_meters

# The kernels' table types, by the code the C interface takes.
TABLE_TYPES = {torch.float32: 0, torch.int16: 1, torch.uint16: 2}
# JAX's gather modes, by the code G1 takes.
GATHER_MODES = {"promise_in_bounds": 0, "clip": 1, "fill": 2}
# Largest dynamic shared memory a block may use on Hopper (G2, G3, G4).
MAX_SMEM_BYTES = 232_448
AXIS_MODES = {"flat": 0, "lane": 1, "sublane": 2}
INT32_MAX = 2**31 - 1
# G4's staged route (this module owns its choice; the kernel takes the
# share it is given): the floats a block stages, a multiple of 4 with its
# 8-byte mbarrier behind them, within MAX_SMEM_BYTES; it serves tables of
# which a block holds at least half (tools/gather_sweep.py).
SHARE_FLOATS = (MAX_SMEM_BYTES - 8) // 16 * 4          # 58,108
G4_STAGED_MAX_ENTRIES = 2 * SHARE_FLOATS                # 116,216 floats

# Kernel launches since the last reset, by kernel and G4's route
# (chip_smoke.py reads and resets these).
launches = {"gather_flat": 0, "gather_axis_smem": 0, "gather_smem_u16": 0,
            "gather_2d_staged": 0, "gather_2d_device": 0}


def g4_staged(entries: int) -> bool:
    """Whether G4 takes its staged route for a table of ``entries`` floats:
    up to ``G4_STAGED_MAX_ENTRIES`` (464,864 bytes), where every block
    stages the table's first ``SHARE_FLOATS`` floats and reads the rest
    from device memory; beyond, the device-memory route."""
    return entries <= G4_STAGED_MAX_ENTRIES


# ------------------------------ plain twins --------------------------- #

def _fill(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's mode="fill" against ``n`` entries: (an in-range index to read,
    where the result is not NaN); an index in ``[-n, 0)`` wraps."""
    j = torch.where(idx < 0, idx + n, idx)
    ok = (j >= 0) & (j < n)
    return torch.where(ok, j, 0), ok


def _clip(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's mode="clip": wrap ``[-n, 0)``, then clip to ``[0, n - 1]``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _nan_where_not(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def gather_mode(clamp: bool, mode) -> str:
    """G1's mode: ``mode`` if given, else "clip" for ``clamp=True`` and
    "promise_in_bounds" otherwise."""
    mode = mode or ("clip" if clamp else "promise_in_bounds")
    if mode not in GATHER_MODES:
        raise ValueError(f"mode must be one of {list(GATHER_MODES)}, "
                         f"got {mode!r}")
    return mode


def gather_flat_plain(table: torch.Tensor, idx: torch.Tensor,
                      clamp: bool = False, mode=None) -> torch.Tensor:
    mode = gather_mode(clamp, mode)
    flat = table.reshape(-1)
    if flat.dtype != torch.float32:
        # Widened before the gather (the same values): PyTorch cannot
        # index uint16 on the card.
        flat = flat.to(torch.float32)
    n = flat.numel()
    if mode == "clip":
        return flat[_clip(idx, n)]
    if mode == "fill":
        j, ok = _fill(idx, n)
        return _nan_where_not(ok, flat[j])
    return flat[idx]


def gather_axis_plain(table: torch.Tensor, idx: torch.Tensor,
                      mode: str) -> torch.Tensor:
    if mode == "flat":
        return gather_flat_plain(table, idx, mode="fill")
    axis = 1 if mode == "lane" else 0
    j, ok = _fill(idx, table.shape[axis])
    return _nan_where_not(ok, torch.gather(table, axis, j))


def gather_u16_plain(table_mm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    j, ok = _fill(idx, table_mm.numel())
    # Widened before the gather: PyTorch cannot index uint16 on the card.
    return _nan_where_not(
        ok, mm_to_meters(table_mm.reshape(-1).to(torch.float32)[j]))


def gather_2d_plain(table: torch.Tensor, vi: torch.Tensor,
                    ui: torch.Tensor) -> torch.Tensor:
    rows, cols = table.shape
    return table[_clip(vi, rows), _clip(ui, cols)]


# -------------------------------- checks ------------------------------ #

def _check(table: torch.Tensor, dtypes, *indices: torch.Tensor) -> str:
    """Validate dtypes, devices and sizes; returns the device type."""
    if table.dtype not in dtypes:
        raise ValueError(f"table dtype must be one of {sorted(map(str, dtypes))},"
                         f" got {table.dtype}")
    if table.numel() == 0 or table.numel() > INT32_MAX:
        raise ValueError(f"table must hold 1..2^31-1 entries, got "
                         f"{table.numel()}")
    for ix in indices:
        if ix.dtype != torch.int32:
            raise ValueError(f"index dtype must be int32, got {ix.dtype}")
        if ix.numel() > INT32_MAX:
            raise ValueError(f"at most 2^31-1 lookups, got {ix.numel()}")
    devices = {t.device for t in (table, *indices)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    kind = table.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if kind == "cuda" and not all(t.is_contiguous()
                                  for t in (table, *indices)):
        raise ValueError("table and indices must be contiguous")
    return kind


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _output_like(idx: torch.Tensor) -> torch.Tensor:
    """An f32 output of ``idx``'s shape at ``idx``'s offset within 16
    bytes, so that the kernels serve both with 16-byte accesses when
    ``idx`` is a slice that does not start on 16 bytes."""
    shift = idx.data_ptr() % 16 // 4
    if shift == 0:
        return torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    buf = torch.empty(idx.numel() + 3, dtype=torch.float32,
                      device=idx.device)
    start = (shift - buf.data_ptr() % 16 // 4) % 4
    return buf[start:start + idx.numel()].view(idx.shape)


def _too_big(nbytes: int) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"table of {nbytes} bytes exceeds the "
                         f"{MAX_SMEM_BYTES} bytes of shared memory a block "
                         f"may use")


# ------------------------------- wrappers ----------------------------- #

def gather_flat(table: torch.Tensor, idx: torch.Tensor,
                clamp: bool = False, mode=None) -> torch.Tensor:
    """G1: f32 ``table.ravel()[idx]`` of any table shape, in JAX's gather
    ``mode`` (``clamp=True`` means "clip")."""
    mode = gather_mode(clamp, mode)
    if _check(table, TABLE_TYPES, idx) == "cpu":
        return gather_flat_plain(table, idx, mode=mode)
    out = _output_like(idx)
    if idx.numel():
        status = build.load().slb_gather_flat(
            table.data_ptr(), TABLE_TYPES[table.dtype], idx.data_ptr(),
            out.data_ptr(), idx.numel(), table.numel(), GATHER_MODES[mode],
            _sm_count(idx), _stream(idx))
        build.check(status, "gather_flat kernel")
        launches["gather_flat"] += 1
    return out


def gather_axis_smem(table: torch.Tensor, idx: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """G2: the f32 [rows, cols] table staged in shared memory; ``mode``
    "flat" (``take(t.ravel(), i)``), "lane" (``take_along_axis(t, i, 1)``)
    or "sublane" (``take_along_axis(t, i, 0)``). An index in ``[-n, 0)``
    along the gathered axis wraps; any other out-of-range one gives NaN."""
    if mode not in AXIS_MODES:
        raise ValueError(f"mode must be one of {list(AXIS_MODES)}, got {mode!r}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table and index must be 2-D, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    rows, cols = table.shape
    if (mode == "lane" and idx.shape[0] != rows) \
            or (mode == "sublane" and idx.shape[1] != cols):
        raise ValueError(f"{mode} gather: index shape {tuple(idx.shape)} does "
                         f"not match the table's {tuple(table.shape)} off the "
                         f"gathered axis")
    _too_big(table.numel() * 4)
    if _check(table, {torch.float32}, idx) == "cpu":
        return gather_axis_plain(table, idx, mode)
    out = _output_like(idx)
    if idx.numel():
        status = build.load().slb_gather_axis_smem_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
            idx.shape[0], idx.shape[1], AXIS_MODES[mode], _sm_count(idx),
            _stream(idx))
        build.check(status, "gather_axis_smem kernel")
        launches["gather_axis_smem"] += 1
    return out


def gather_smem_u16(table_mm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G3: metres ``float(table_mm.ravel()[idx]) / 1000`` with the uint16
    millimetre image staged in shared memory (at most 116,224 entries);
    an index in ``[-n, 0)`` wraps, any other out-of-range one gives NaN."""
    _too_big(table_mm.numel() * 2)
    if _check(table_mm, {torch.uint16}, idx) == "cpu":
        return gather_u16_plain(table_mm, idx)
    out = _output_like(idx)
    if idx.numel():
        status = build.load().slb_gather_smem_u16(
            table_mm.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table_mm.numel(), _sm_count(idx), _stream(idx))
        build.check(status, "gather_smem_u16 kernel")
        launches["gather_smem_u16"] += 1
    return out


def gather_2d(table: torch.Tensor, vi: torch.Tensor,
              ui: torch.Tensor) -> torch.Tensor:
    """G4: ``table[vi, ui]`` of an f32 [rows, cols] table, each index
    wrapped from ``[-n, 0)`` and clipped to ``[0, n - 1]`` along its axis.
    Tables of up to ``G4_STAGED_MAX_ENTRIES`` floats (464,864 bytes) take
    the staged route: every block stages the first ``SHARE_FLOATS``
    (232,432 bytes; all of a table that fits) by TMA and reads the rest
    from device memory. Larger tables take the device-memory route. The
    route depends on the table's size alone (``g4_staged``)."""
    if table.dim() != 2 or vi.shape != ui.shape:
        raise ValueError(f"table must be 2-D and vi, ui of one shape, got "
                         f"{tuple(table.shape)}, {tuple(vi.shape)}, "
                         f"{tuple(ui.shape)}")
    if _check(table, {torch.float32}, vi, ui) == "cpu":
        return gather_2d_plain(table, vi, ui)
    out = _output_like(vi)
    if vi.numel():
        staged = g4_staged(table.numel())
        status = build.load().slb_gather_2d_f32(
            table.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(),
            vi.numel(), *table.shape, SHARE_FLOATS if staged else 0,
            _sm_count(vi), _stream(vi))
        build.check(status, "gather_2d kernel")
        launches["gather_2d_staged" if staged else "gather_2d_device"] += 1
    return out
