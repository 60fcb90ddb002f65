"""The copy probe: the roofline tool's bandwidth control
(``tools/roofline.py``, counterpart of ``tools_roofline_4096.py``'s Pallas
``make_copy``).

``copy_probe(f, out, aux)`` copies a [9, H, W] f32 field into ``out``; with
``aux`` [H, W] it also reads the aux plane, folded into the store as
``out[0] = f[0] + 0 aux``. On a CUDA tensor it launches the hand-written
kernel (``csrc/copy_probe.cu``) or raises; on a CPU tensor it runs the plain
version. ``LAUNCHES`` counts kernel launches by variant.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

VARIANTS = ("copy_probe", "copy_probe_aux")
LAUNCHES = {name: 0 for name in VARIANTS}


def variant(aux: Optional[torch.Tensor]) -> str:
    return VARIANTS[aux is not None]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def copy_probe_plain(f: torch.Tensor, out: torch.Tensor, aux: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the copy, then the aux read on plane 0."""
    out.copy_(f)
    if aux is not None:
        out[0] += 0.0 * aux


def copy_probe(f: torch.Tensor, out: torch.Tensor, aux: Optional[torch.Tensor] = None):
    if not f.is_cuda:
        return copy_probe_plain(f, out, aux)
    _, H, W = f.shape
    for name, t, shape in (("f", f, (9, H, W)), ("out", out, (9, H, W)),
                           ("aux", aux, (H, W))):
        if t is None:
            continue
        if t.device != f.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"copy_probe: {name} must be a contiguous float32 tensor on "
                             f"{f.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"copy_probe: {name} shape {tuple(t.shape)} != {shape}")
    if f.data_ptr() == out.data_ptr():
        raise ValueError("copy_probe: needs distinct in/out buffers")
    rc = cuda_build.load("copy_probe")(
        f.data_ptr(), out.data_ptr(), None if aux is None else aux.data_ptr(), H, W,
        torch.cuda.current_stream(f.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"copy_probe launch failed: CUDA error {rc}")
    LAUNCHES[variant(aux)] += 1
