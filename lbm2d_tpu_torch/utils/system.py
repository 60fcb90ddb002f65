"""System utilities (reference utils/system_utils.py role; counterpart of
``lbm2d_tpu/utils/system.py``).

The reference purges Taichi's JIT cache between cases (a Windows lockfile
workaround, system_utils.py:6-23); the JAX package clears its trace and
compile caches. The port frees its per-shape host caches and PyTorch's
cached CUDA blocks. Also provides the random mask picker used by
exploratory runs.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import torch


def force_clean_cache() -> None:
    """Clear the per-shape host caches (``ops/cuda_step._whole_grid``) and,
    where CUDA is initialised, return PyTorch's cached blocks to the card
    (``torch.cuda.empty_cache``). The loaded kernel libraries
    (``ops/cuda_build._LIBS``) stay loaded: rebuilding them costs nvcc runs.

    Safe to call between cases; a later case rebuilds what it needs.
    """
    from ..ops import cuda_step

    cuda_step._whole_grid.cache_clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def pick_random_png(directory: str, rng: Optional[random.Random] = None) -> str:
    """Random PNG path from a directory (reference random mask picker),
    drawn from ``rng`` (a fresh generator when None)."""
    r = rng or random.Random()
    pngs: List[str] = sorted(
        f for f in os.listdir(directory) if f.lower().endswith(".png")
    )
    if not pngs:
        raise FileNotFoundError(f"no PNG files in {directory}")
    return os.path.join(directory, r.choice(pngs))
