"""The one-axis mesh of the sharded step (port of
``slambench_tpu/parallel/mesh.py``).

JAX's mesh is a ``jax.sharding.Mesh`` over devices, and ``shard_map``
runs one program per device. Here the mesh is a ``torch.distributed``
process group over one axis (``z``): every rank is one shard and runs
the step SPMD, rank ``r`` on the TSDF's ``r``-th z-slab and the images'
``r``-th row block. ``parallel/distributed.py`` makes the group.

The mesh owns the collectives the step needs, with a tally of calls,
bytes and host seconds by the name of ``parallel/comm.py:
analytic_traffic``'s line that each one carries (``bytes`` is the
collective's result buffer, as the HLO shapes JAX's account reads;
``seconds`` the host's time in the call, which over gloo includes
waiting for the work queued before it, and over NCCL only the enqueue):

* ``psum``: ``all_reduce`` SUM; ``pmin``: ``all_reduce`` MIN;
* ``all_gather_rows``: a tiled ``all_gather`` along the first axis;
* ``halo``: the ring halo of JAX's ``ppermute``: each rank gets the
  ``h`` planes just below its slab from the rank before and the ``h``
  just above from the rank after. Over NCCL, and over gloo with CPU
  tensors, it goes by ``isend`` / ``irecv``; gloo's point-to-point takes
  CPU tensors only, so with CUDA tensors over gloo (two ranks sharing
  one card, where NCCL refuses a device twice) every rank gathers both
  edges of every slab by ``all_gather`` and keeps its neighbours'. The
  tally then books the ``ppermute`` payload under ``halo_ppermute`` and
  what the transport moves beyond it under ``halo_all_gather_extra``.

The route is chosen from the group's backend and the device when the
mesh is made (``halo_by_gather``), never by catching a failed call; so
is whether a CUDA graph may capture the collectives (``capturable``:
NCCL's are, gloo's are host calls). Checks that are not part of the
step (``assert_replicated``) are tallied apart, in ``check_tally``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.distributed as dist


class Mesh:
    """A 1-D mesh: this process's rank of the default process group, on
    ``device``."""

    axis_name = "z"

    def __init__(self, device: torch.device, owns_group: bool = False):
        self.device = torch.device(device)
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        # Whether close() destroys the group (made for this mesh alone).
        self.owns_group = owns_group
        self.halo_by_gather = (self.backend == "gloo"
                               and self.device.type == "cuda")
        self.capturable = self.backend == "nccl"
        self.tally: Dict[str, dict] = {}
        self.check_tally: Dict[str, dict] = {}

    # ------------------------------------------------------------------ #

    def describe(self) -> str:
        return (f"mesh {self.axis_name}:{self.size}, rank {self.rank}, "
                f"{self.backend} on {self.device}, halo by "
                + ("all_gather" if self.halo_by_gather else "isend/irecv"))

    def reset_tally(self) -> None:
        """Start a new tally of the step's collectives (the checks'
        tally runs on)."""
        self.tally = {}

    def _book(self, tag: str, nbytes: int, count: int = 1,
              book: Optional[dict] = None, t0: Optional[float] = None
              ) -> None:
        book = self.tally if book is None else book
        e = book.setdefault(tag, {"count": 0, "bytes": 0, "seconds": 0.0})
        e["count"] += count
        e["bytes"] += int(nbytes)
        if t0 is not None:
            e["seconds"] += time.perf_counter() - t0

    def psum(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Sum over the ranks (a new tensor)."""
        t0 = time.perf_counter()
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM)
        self._book(tag, out.nbytes, t0=t0)
        return out

    def pmin(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Elementwise minimum over the ranks (a new tensor)."""
        t0 = time.perf_counter()
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.MIN)
        self._book(tag, out.nbytes, t0=t0)
        return out

    def _gather(self, x: torch.Tensor) -> list:
        """``all_gather`` of a contiguous ``x``, rank order. Gloo takes no
        int16, so over gloo every tensor that is not float32 travels as
        its float32 bit pattern (a copy: no arithmetic touches it; the
        size must be a multiple of 4 bytes)."""
        wire = x
        if self.backend == "gloo" and x.dtype != torch.float32:
            wire = x.reshape(-1).view(torch.float32)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire)
        return [p.view(x.dtype).reshape(x.shape) for p in parts]

    def all_gather_rows(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` stacked along the first axis, rank order
        (JAX's ``all_gather(..., tiled=True)``)."""
        t0 = time.perf_counter()
        out = torch.cat(self._gather(x.contiguous()))
        self._book(tag, out.nbytes, t0=t0)
        return out

    def halo(self, slab: torch.Tensor, h: int,
             tag: str = "halo_ppermute") -> torch.Tensor:
        """``slab`` [Z, ...] extended by the ``h`` planes before it (the
        previous rank's last planes) and the ``h`` after it (the next
        rank's first planes), ring order. One rank wraps its own slab,
        as JAX does; edge ranks get the ring's far slab there, which the
        callers never read (global z is clamped first)."""
        n = self.size
        first, last = slab[:h].contiguous(), slab[-h:].contiguous()
        if n == 1:
            return torch.cat([first, slab, last])
        t0 = time.perf_counter()
        prev, nxt = (self.rank - 1) % n, (self.rank + 1) % n
        payload = 2 * first.nbytes
        if self.halo_by_gather:
            parts = self._gather(torch.cat([first, last]))
            top, bottom = parts[prev][h:], parts[nxt][:h]
            self._book(tag, payload, count=2, t0=t0)
            self._book("halo_all_gather_extra", n * payload - payload)
        else:
            top, bottom = torch.empty_like(last), torch.empty_like(first)
            # Tag 0: last planes to the next rank's top; tag 1: first
            # planes to the previous rank's bottom (at n = 2 both peers
            # are one rank, and the tags keep the two apart).
            ops = [dist.P2POp(dist.isend, last, nxt, tag=0),
                   dist.P2POp(dist.isend, first, prev, tag=1),
                   dist.P2POp(dist.irecv, top, prev, tag=0),
                   dist.P2POp(dist.irecv, bottom, nxt, tag=1)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self._book(tag, payload, count=2, t0=t0)
        return torch.cat([top, slab, bottom])

    def assert_replicated(self, x: torch.Tensor, what: str) -> None:
        """Raise unless ``x`` holds the same bits on every rank."""
        if self.size == 1:
            return
        parts = [p.view(torch.uint8) for p in
                 self._gather(x.detach().contiguous().reshape(-1))]
        self._book("replication_check", sum(p.nbytes for p in parts),
                   book=self.check_tally)
        if not all(torch.equal(parts[0], p) for p in parts[1:]):
            raise RuntimeError(f"{what} differs across the {self.size} "
                               f"ranks of the mesh")

    def close(self) -> None:
        """Destroy the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def make_mesh(n_ranks: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of this process's rank: joins the group of ``n_ranks``
    ranks (``parallel/distributed.initialize``; None or 0 = the world
    size that the launcher gave)."""
    from slambench_tpu_torch.parallel import distributed
    return distributed.initialize(n_ranks or 0, device)


def parse_mesh_spec(spec: str) -> int:
    """Parse the CLI ``--mesh axis:n`` extension; returns n (0 = all)."""
    if not spec:
        return 0
    if ":" in spec:
        return int(spec.split(":", 1)[1])
    return int(spec)
