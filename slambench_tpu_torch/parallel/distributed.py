"""Process-group set-up for the sharded step (port of
``slambench_tpu/parallel/distributed.py``).

JAX wires hosts with ``jax.distributed`` and then sees every device of
the slice. Here each rank is a process: ``initialize`` joins the group
that a launcher describes through ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and returns the rank's ``parallel/mesh.Mesh``. With
none of them set and one rank asked for, it makes a one-rank group in
the process, on an in-process store (no socket).

Devices and backends: a rank runs on ``cuda:{LOCAL_RANK %
device_count}``, so ranks beyond the host's card count share cards
(two ranks on one H100). NCCL refuses a card twice in one group, so the
group is NCCL when every rank of the host has a card of its own and
gloo when ranks share one (gloo stages CUDA tensors through host memory
for its collectives); on the CPU it is gloo.

``launch`` starts ``n`` ranks of a command as subprocesses with that
environment (the tests and the tools' own launcher; the CLI runs under
``torchrun``). ``is_primary`` is rank 0, which alone writes logs and
summaries.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from slambench_tpu_torch.parallel.mesh import Mesh
from slambench_tpu_torch.policy import resolve_device


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each rank of the host has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(n_ranks: int = 0, device="cuda") -> Mesh:
    """Join (or, for one rank without a launcher, make) the process
    group and return this rank's mesh. ``n_ranks`` 0 takes the world
    size the launcher set; any other count must equal it. ``device`` is
    ``"cuda"`` or ``"cpu"`` (an index is replaced by the rank's own)."""
    kind = torch.device(device).type
    launched = "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    if n_ranks and n_ranks != world:
        if launched:
            raise RuntimeError(
                f"--mesh asks for {n_ranks} ranks but the launcher started "
                f"{world}: run under torchrun --nproc-per-node {n_ranks}")
        raise RuntimeError(
            f"--mesh z:{n_ranks} needs {n_ranks} processes: run it under "
            f"torchrun --nproc-per-node {n_ranks}")
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if kind == "cuda":
        resolve_device("cuda")                 # raises without a card
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    backend = choose_backend(dev, local_world)
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; {world} asked for")
        return Mesh(dev)
    if launched:
        dist.init_process_group(backend, rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return Mesh(dev, owns_group=True)


def is_primary() -> bool:
    """Logs and summaries go to rank 0 (no group: this process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, argv: Sequence[str], *, cwd: Optional[str] = None,
           timeout: float = 600.0) -> List[Tuple[int, str, str]]:
    """Run ``n`` ranks of ``[python, *argv]`` on this host, with
    ``torchrun``'s environment and a free localhost port; returns each
    rank's (exit code, stdout, stderr), rank order. A rank that outlives
    ``timeout`` is killed with the rest, and the timeout is raised."""
    port = free_port()
    procs = []
    for r in range(n):
        e = dict(os.environ)
        e.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=cwd, env=e, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
