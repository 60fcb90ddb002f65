"""What a dataset run saves, worked out plainly: the cropped, area-averaged
moment frame of the HDF5 dataset, and the video frame rendered from the
velocity field.

The dataset frame crops x to [sponge_in, nx - sponge_out - buffer) and y to
[sponge_bot + buffer, ny - sponge_top - buffer), then averages each output
pixel over the input area it covers (OpenCV's INTER_AREA when shrinking) to
``save_resolution_height`` rows.

The video frame (the device renderer's two panels): the velocity smoothed by
a gaussian (sigma from the configuration, 4 sigma half-width, mirrored
edges), the speed on matplotlib's ``plasma`` over [0, 0.15] above the
vorticity du/dy - dv/dx (central differences, one-sided at the edges) on the
five-stop vorticity map over [-0.03, 0.03], solid cells grey, each map
indexed by floor(256 x), resized bilinearly with pixel centres at half
steps, truncated to 8 bits and converted to I420 (BT.601 limited range,
chroma from each 2x2 block's top-left pixel). ``colormaps.npz`` holds the
two maps as matplotlib samples them at i / 255: ``plasma`` from
``matplotlib.colormaps`` and ``vorticity`` from
``LinearSegmentedColormap.from_list`` over the stops yellow (1, 1, 0),
orange (0.953, 0.490, 0.016), black, green (0.176, 0.976, 0.529) and cyan.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .lbm import moments

_MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "colormaps.npz")


def area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src]: each output cell the mean of the input it overlaps."""
    scale = src / dst
    w = np.zeros((dst, src))
    for o in range(dst):
        lo, hi = o * scale, (o + 1) * scale
        for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            w[o, i] = max(0.0, min(hi, i + 1) - max(lo, i))
    return w / w.sum(axis=1, keepdims=True)


def crop_box(config: dict):
    """(y slice, x slice, target height, target width) of the saved frame."""
    sim, z = config["simulation"], config["domain_zones"]
    nx, ny, buf = int(sim["nx"]), int(sim["ny"]), int(z["buffer"])
    ys = slice(z["sponge_bot"] + buf, ny - z["sponge_top"] - buf)
    xs = slice(z["sponge_in"], nx - z["sponge_out"] - buf)
    th = int(config["outputs"]["dataset"]["save_resolution_height"])
    tw = int((xs.stop - xs.start) * (th / (ys.stop - ys.start)))
    return ys, xs, th, tw


def dataset_frame(f_post: torch.Tensor, config: dict, store=None) -> torch.Tensor:
    """[9, th, tw] saved moment frame of a case's f_post, in f_post's dtype;
    ``store`` (a dtype) rounds it to that type and back, as a frame sent in
    that type would be."""
    ys, xs, th, tw = crop_box(config)
    m = moments(f_post)[:, ys, xs]
    wy = torch.as_tensor(area_weights(m.shape[1], th), dtype=m.dtype, device=m.device)
    wx = torch.as_tensor(area_weights(m.shape[2], tw), dtype=m.dtype, device=m.device)
    out = torch.einsum("ah,chw,bw->cab", wy, m, wx)
    return out if store is None else out.to(store).to(out.dtype)


def gui_size(nx: int, ny: int, max_size) -> tuple:
    """(width, height of the two stacked panels) with the longer side of the
    grid brought to at most ``max_size``."""
    w, h = nx, ny
    if max_size and max(nx, ny) > max_size:
        r = max_size / max(nx, ny)
        w, h = int(nx * r), int(ny * r)
    return max(1, w), 2 * max(1, h)


def _mirror(n: int, r: int) -> np.ndarray:
    i = np.arange(-r, n + r)
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - i - 1, i)


def _blur(a: torch.Tensor, sigma: float) -> torch.Tensor:
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * x * x / (sigma * sigma))
    k = torch.as_tensor(k / k.sum(), dtype=a.dtype, device=a.device)
    h, w = a.shape
    p = a[torch.as_tensor(_mirror(h, r), device=a.device)]
    a = sum(k[i] * p[i:i + h] for i in range(2 * r + 1))
    p = a[:, torch.as_tensor(_mirror(w, r), device=a.device)]
    return sum(k[i] * p[:, i:i + w] for i in range(2 * r + 1))


def _grad(a: torch.Tensor, axis: int) -> torch.Tensor:
    out = torch.empty_like(a)
    n = a.shape[axis]
    mid = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) / 2
    out.narrow(axis, 1, n - 2).copy_(mid)
    out.narrow(axis, 0, 1).copy_(a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1))
    out.narrow(axis, n - 1, 1).copy_(a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1))
    return out


def _paint(v: torch.Tensor, lo: float, hi: float, lut: torch.Tensor, solid) -> torch.Tensor:
    idx = torch.clamp(torch.floor((v - lo) / (hi - lo) * 256), 0, 255).long()
    rgb = lut[idx]
    return torch.where(solid[..., None], torch.full_like(rgb, 0.5), rgb)


def _linear(img: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    n = img.shape[axis]
    if n == n_out:
        return img
    src = (np.arange(n_out) + 0.5) * n / n_out - 0.5
    src = np.clip(src, 0, n - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    t = torch.as_tensor(src - lo, dtype=img.dtype, device=img.device)
    shape = [1] * img.dim()
    shape[axis] = n_out
    t = t.reshape(shape)
    a = img.index_select(axis, torch.as_tensor(lo, device=img.device))
    b = img.index_select(axis, torch.as_tensor(hi, device=img.device))
    return a * (1 - t) + b * t


def video_frame(u: torch.Tensor, solid: torch.Tensor, config: dict, dtype=torch.float64):
    """(Y [He, We], UV [He/2, We/2, 2]) uint8 of one case, computed in
    ``dtype`` (float64 unless a lower-precision control asks for less)."""
    sim, gui = config["simulation"], config["outputs"]["gui"]
    gw, gh = gui_size(int(sim["nx"]), int(sim["ny"]), gui.get("max_size"))
    maps = np.load(_MAPS)
    plasma = torch.as_tensor(maps["plasma"], dtype=dtype, device=u.device)
    vort_map = torch.as_tensor(maps["vorticity"], dtype=dtype, device=u.device)
    ux, uy = u[0].to(dtype), u[1].to(dtype)
    sigma = float(gui.get("gaussian_sigma", 1.0))
    if sigma > 0:
        ux, uy = _blur(ux, sigma), _blur(uy, sigma)
    speed = torch.sqrt(ux * ux + uy * uy)
    vort = _grad(ux, 0) - _grad(uy, 1)
    img = torch.cat([_paint(speed, 0.0, 0.15, plasma, solid),
                     _paint(vort, -0.03, 0.03, vort_map, solid)], dim=0)
    img = _linear(_linear(img, gh, 0), gw, 1)
    rgb = torch.floor(torch.clamp(img, 0, 1) * 255)[: gh - gh % 2, : gw - gw % 2]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    r, g, b = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    q = lambda a: torch.clamp(torch.round(a), 0, 255).to(torch.uint8)  # noqa: E731
    return q(y), torch.stack([q(cb), q(cr)], dim=-1)
