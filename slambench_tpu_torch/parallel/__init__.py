"""The sharded frame step over a ``torch.distributed`` mesh (port of
``slambench_tpu/parallel``): the TSDF in z-slabs, one per rank, the ICP
normal equations completed by a ``psum`` an iteration, the raycast
composited across slabs with a halo exchange, and the bilateral filter
on row bands (``step.py``); the mesh and its collectives (``mesh.py``),
the process group (``distributed.py``) and the traffic account
(``comm.py``)."""

from slambench_tpu_torch.parallel.mesh import make_mesh
from slambench_tpu_torch.parallel.step import ShardedKFusion
