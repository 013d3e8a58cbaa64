"""slambench_tpu_torch — the KinectFusion benchmark in PyTorch and CUDA.

A port of ``slambench_tpu`` (JAX/XLA/Pallas) to PyTorch on an NVIDIA
H100. The JAX package is the reference each module here is tested
against; this package imports ``torch`` and ``numpy`` and never ``jax``.
Module names mirror the JAX package's so each counterpart is easy to
find:

  params/geometry/volume  — math & data substrate
  ops/                    — plain-torch ops; ``ops/hopper`` holds the
                            hand-written CUDA kernels and their wrappers
  pipeline                — ``KFusionState`` + ``KFusion`` frame step
  convert                 — state exchange with the JAX package (numpy)
  io/, eval/, config      — host side, copied from the JAX package
  frontend/benchmark      — the CLI (``python -m
                            slambench_tpu_torch.frontend.benchmark``)
"""

__version__ = "0.1.0"
