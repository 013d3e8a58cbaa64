"""G1-G4 wrappers: table gathers as hand-written CUDA kernels.

The kernels (``csrc/gather.cu``) are the Hopper counterparts of the three
Pallas gather probes in ``slambench_tpu/tools/mosaic_probe.py`` (P1-P3)
and serve the port's gather probes (``tools/mosaic_probe.py``,
``tools/gather_probe.py``):

* G1 ``gather_flat``: ``out = table.ravel()[idx]`` from device memory,
  f32 / int16 / uint16 tables widened to f32, several lookups a thread;
  ``clamp`` does what JAX's ``mode="clip"`` does: an index in ``[-n, 0)``
  first becomes ``idx + n`` (NumPy-style), then the index is clipped to
  ``[0, n - 1]``; without it the indices must be in range, as
  ``promise_in_bounds``;
* G2 ``gather_axis_smem``: a flat, lane (``axis=1``) or sublane
  (``axis=0``) gather from an f32 table staged in shared memory: each
  block stages only what its outputs read (flat: a share of the table
  per block of a thread-block cluster, read across the cluster);
* G3 ``gather_smem_u16``: the uint16 millimetre image staged in shared
  memory, each lookup converted to metres by IEEE division, as the JAX
  package's ``mm2meters`` (``ops/preprocess.py:mm_to_meters``);
* G4 ``gather_2d``: ``out = table[vi, ui]``.

Each has a plain twin here (``*_plain``): the one PyTorch indexing call
that computes the same gather, plus the widening or clamping glue its
contract needs. A wrapper runs the twin only for CPU tensors; for CUDA
tensors it launches its kernel or raises. Indices are int32 tensors.
"""

from __future__ import annotations

import torch

from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.preprocess import mm_to_meters

# The kernels' table types, by the code the C interface takes.
TABLE_TYPES = {torch.float32: 0, torch.int16: 1, torch.uint16: 2}
# Largest dynamic shared memory a block may use on Hopper (G2, G3).
MAX_SMEM_BYTES = 232_448
AXIS_MODES = {"flat": 0, "lane": 1, "sublane": 2}
INT32_MAX = 2**31 - 1

# Kernel launches since the last reset, by kernel (chip_smoke.py reads
# and resets these).
launches = {"gather_flat": 0, "gather_axis_smem": 0, "gather_smem_u16": 0,
            "gather_2d": 0}


# ------------------------------ plain twins --------------------------- #

def gather_flat_plain(table: torch.Tensor, idx: torch.Tensor,
                      clamp: bool = False) -> torch.Tensor:
    flat = table.reshape(-1)
    if flat.dtype != torch.float32:
        # Widened before the gather (the same values): PyTorch cannot
        # index uint16 on the card.
        flat = flat.to(torch.float32)
    if clamp:
        n = flat.numel()
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx]


def gather_axis_plain(table: torch.Tensor, idx: torch.Tensor,
                      mode: str) -> torch.Tensor:
    if mode == "flat":
        return table.reshape(-1)[idx]
    return torch.gather(table, 1 if mode == "lane" else 0, idx)


def gather_u16_plain(table_mm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # Widened before the gather: PyTorch cannot index uint16 on the card.
    return mm_to_meters(table_mm.reshape(-1).to(torch.float32)[idx])


def gather_2d_plain(table: torch.Tensor, vi: torch.Tensor,
                    ui: torch.Tensor) -> torch.Tensor:
    return table[vi, ui]


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
    bytes, so that G1 and G2 serve both with 16-byte accesses when
    ``idx`` is a slice that does not start on 16 bytes."""
    shift = idx.data_ptr() % 16 // 4
    if shift == 0:
        return torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    buf = torch.empty(idx.numel() + 3, dtype=torch.float32,
                      device=idx.device)
    start = (shift - buf.data_ptr() % 16 // 4) % 4
    return buf[start:start + idx.numel()].view(idx.shape)


# ------------------------------- wrappers ----------------------------- #

def gather_flat(table: torch.Tensor, idx: torch.Tensor,
                clamp: bool = False) -> torch.Tensor:
    """G1: f32 ``table.ravel()[idx]`` of any table shape."""
    if _check(table, TABLE_TYPES, idx) == "cpu":
        return gather_flat_plain(table, idx, clamp)
    out = _output_like(idx)
    if idx.numel():
        status = build.load().slb_gather_flat(
            table.data_ptr(), TABLE_TYPES[table.dtype], idx.data_ptr(),
            out.data_ptr(), idx.numel(), table.numel(), int(clamp),
            _sm_count(idx), _stream(idx))
        build.check(status, "gather_flat kernel")
        launches["gather_flat"] += 1
    return out


def gather_axis_smem(table: torch.Tensor, idx: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """G2: the f32 [rows, cols] table staged in shared memory; ``mode``
    "flat" (``take(t.ravel(), i)``), "lane" (``take_along_axis(t, i, 1)``)
    or "sublane" (``take_along_axis(t, i, 0)``). Indices are clamped into
    the table (a negative one to 0)."""
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
    if table.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"table of {table.numel() * 4} bytes exceeds the "
                         f"{MAX_SMEM_BYTES} bytes of shared memory a block "
                         f"may use")
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
    millimetre image staged in shared memory."""
    if table_mm.numel() * 2 > MAX_SMEM_BYTES:
        raise ValueError(f"table of {table_mm.numel() * 2} bytes exceeds the "
                         f"{MAX_SMEM_BYTES} bytes of shared memory a block "
                         f"may use")
    if _check(table_mm, {torch.uint16}, idx) == "cpu":
        return gather_u16_plain(table_mm, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel():
        status = build.load().slb_gather_smem_u16(
            table_mm.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table_mm.numel(), _sm_count(idx), _stream(idx))
        build.check(status, "gather_smem_u16 kernel")
        launches["gather_smem_u16"] += 1
    return out


def gather_2d(table: torch.Tensor, vi: torch.Tensor,
              ui: torch.Tensor) -> torch.Tensor:
    """G4: ``table[vi, ui]`` of an f32 [rows, cols] table; in range."""
    if table.dim() != 2 or vi.shape != ui.shape:
        raise ValueError(f"table must be 2-D and vi, ui of one shape, got "
                         f"{tuple(table.shape)}, {tuple(vi.shape)}, "
                         f"{tuple(ui.shape)}")
    if _check(table, {torch.float32}, vi, ui) == "cpu":
        return gather_2d_plain(table, vi, ui)
    out = torch.empty(vi.shape, dtype=torch.float32, device=vi.device)
    if vi.numel():
        status = build.load().slb_gather_2d_f32(
            table.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(),
            vi.numel(), table.shape[1], _stream(vi))
        build.check(status, "gather_2d kernel")
        launches["gather_2d"] += 1
    return out
