"""Pipeline state across packages: the port's "weights".

A state is a dict of numpy arrays under the JAX ``KFusionState`` leaf
names, the form ``slambench_tpu/utils/checkpoint.py`` writes
(``{f.name: np.asarray(...)}``). It loads into the port unchanged, and
the port's state converts back the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from slambench_tpu_torch.pipeline import KFusionState

LEAVES = tuple(f.name for f in dataclasses.fields(KFusionState))


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device: torch.device) -> KFusionState:
    """KFusionState on ``device`` from numpy leaves (dtypes kept)."""
    missing = set(LEAVES) - set(arrays)
    extra = set(arrays) - set(LEAVES)
    if missing or extra:
        raise ValueError(f"state leaves differ: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    return KFusionState(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in LEAVES})


def state_to_numpy(state: KFusionState) -> Dict[str, np.ndarray]:
    """Numpy leaves of a port state, under the JAX leaf names."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in LEAVES}
