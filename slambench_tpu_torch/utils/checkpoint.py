"""Checkpoint / resume: the whole pipeline state in one ``.npz``.

The file is the one ``slambench_tpu/utils/checkpoint.py`` writes: every
``KFusionState`` leaf under its JAX name and dtype, plus ``__frame__``
(int64), the number of frames the state has seen. A file either package
writes loads in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slambench_tpu_torch.convert import state_from_numpy, state_to_numpy
from slambench_tpu_torch.pipeline import KFusionState


def save_state(path: str, state: KFusionState, frame: int) -> None:
    arrays = state_to_numpy(state)
    arrays["__frame__"] = np.asarray(frame, np.int64)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device: torch.device
               ) -> Tuple[KFusionState, int]:
    """(state on ``device``, frame count) from a checkpoint."""
    with np.load(path) as z:
        frame = int(z["__frame__"])
        leaves = {k: z[k] for k in z.files if k != "__frame__"}
    return state_from_numpy(leaves, device), frame
