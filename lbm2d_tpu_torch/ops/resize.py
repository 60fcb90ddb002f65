"""Image resize ops: cv2-compatible area-average / nearest, host and device.

The dataset pipeline downsizes cropped moment frames to a fixed save height
(reference io/lbm_writer.py:150-163, cv2.INTER_AREA per channel). Host path
uses cv2 when present; the numpy fallback implements the identical
area-weighted average. ``make_device_resizer`` expresses the separable
area average as two small f32 matmuls on the frames' device, so the
batched datagen resizes on the card and ships only [9, 256, W'] to the
host instead of the full grid.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _area_weights(src: int, dst: int, dtype=np.float64) -> np.ndarray:
    """[dst, src] row-stochastic area-overlap weights for 1-D downscale."""
    scale = src / dst
    w = np.zeros((dst, src), dtype)
    for o in range(dst):
        a, b = o * scale, (o + 1) * scale
        i0, i1 = int(np.floor(a)), int(np.ceil(b))
        for i in range(i0, min(i1, src)):
            overlap = min(b, i + 1) - max(a, i)
            if overlap > 0:
                w[o, i] = overlap
        w[o] /= w[o].sum()
    return w


def _linear_weights(src: int, dst: int, dtype=np.float64) -> np.ndarray:
    """[dst, src] bilinear weights with cv2's half-pixel center convention."""
    scale = src / dst
    w = np.zeros((dst, src), dtype)
    for o in range(dst):
        x = (o + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        xa, xb = np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1)
        w[o, xa] += 1 - t
        w[o, xb] += t
    return w


def resize_weights(src: int, dst: int, dtype=np.float64) -> np.ndarray:
    """INTER_AREA semantics: area average when shrinking, bilinear else."""
    return _area_weights(src, dst, dtype) if dst <= src else _linear_weights(src, dst, dtype)


def resize_area(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Host-side INTER_AREA resize of a [H, W] array."""
    if _HAS_CV2:
        return cv2.resize(np.ascontiguousarray(img), (dst_w, dst_h), interpolation=cv2.INTER_AREA)
    wy = resize_weights(img.shape[0], dst_h)
    wx = resize_weights(img.shape[1], dst_w)
    return (wy @ img.astype(np.float64) @ wx.T).astype(img.dtype)


def resize_nearest(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Host-side INTER_NEAREST resize of a [H, W] array."""
    if _HAS_CV2:
        return cv2.resize(np.ascontiguousarray(img), (dst_w, dst_h), interpolation=cv2.INTER_NEAREST)
    h, w = img.shape
    ys = np.minimum(np.floor(np.arange(dst_h) * h / dst_h).astype(int), h - 1)
    xs = np.minimum(np.floor(np.arange(dst_w) * w / dst_w).astype(int), w - 1)
    return img[np.ix_(ys, xs)]


def make_device_resizer(src_h: int, src_w: int, dst_h: int, dst_w: int, dtype=torch.float32):
    """Return fn [.., src_h, src_w] -> [.., dst_h, dst_w] (area average) on
    the input's device; channel and batch dims broadcast.

    Full f32 products: TF32 keeps about three decimal digits and would make
    device-resized dataset frames visibly coarser than the host
    cv2.INTER_AREA path (the JAX package forces HIGHEST precision for the
    same reason), so TF32 is switched off around the two products.
    """
    wy_np = resize_weights(src_h, dst_h, np.float32)
    wx_t_np = np.ascontiguousarray(resize_weights(src_w, dst_w, np.float32).T)
    weights = {}

    @torch.no_grad()
    def _resize(x: torch.Tensor) -> torch.Tensor:
        if x.device not in weights:
            weights[x.device] = (
                torch.as_tensor(wy_np, dtype=dtype, device=x.device),
                torch.as_tensor(wx_t_np, dtype=dtype, device=x.device),
            )
        wy, wx_t = weights[x.device]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(torch.matmul(wy, x), wx_t)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    return _resize
