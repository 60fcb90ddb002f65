"""Device-side video frames: |u|, vorticity, colormap and resize in torch.

Counterpart of ``lbm2d_tpu/ops/render.py``. The host composer
(viz/frames.py) fetches the full-resolution velocity field per video frame
(~22 MB f32 at 2432x1152) and renders with scipy/matplotlib/cv2; this
module runs the same pipeline on the field's device and ships only the
composed uint8 frame: gaussian smoothing, velocity magnitude and vorticity
(sign convention du/dy - dv/dx), 256-entry colormap LUTs, obstacle grey,
panel stacking and a cv2.INTER_LINEAR-convention bilinear resize, in the
host composer's stage order (colorize at raw resolution, then resize).

On a CUDA tensor the frame is one launch of a hand-written kernel over all
the cases of a call (``csrc/render.cu``), bitwise the plain torch ops of
this module on the card; its tables are made once a shape and device
(``_kernel_tables``), so a call makes no host sync and no host-to-device
copy and queues behind the chunk it reads. On a CPU tensor the plain torch
ops run, as the JAX package leaves them to XLA (no Pallas kernel). Parity
with the host path:
  * scipy.ndimage.gaussian_filter: truncate=4.0, 9-tap separable kernel,
    'reflect' boundary (numpy's 'symmetric' padding).
  * matplotlib colormap indexing: idx = clip(floor(norm * 256), 0, 255);
    the LUTs are the exact matplotlib samples, stored in
    ``data/render_luts.npz`` so the card's machine needs no matplotlib.
  * cv2.INTER_LINEAR: src = (dst + 0.5) * (src_size / dst_size) - 0.5,
    edge-clamped.
  * VideoRecorder's float->uint8 is (clip(x, 0, 1) * 255) truncation.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

LUTS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data", "render_luts.npz")


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d (order 0), float64."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()


# the colormaps shipped in LUTS_PATH: plasma for |u|, the 5-stop vorticity
# map, RdBu_r for pressure (viz/colorize.py)
COLORMAPS = ("plasma", "vorticity", "RdBu_r")


@functools.lru_cache(maxsize=None)
def _lut_file():
    with np.load(LUTS_PATH) as z:
        return {k: z[k].copy() for k in z.files}


def render_luts():
    """(plasma, vorticity) colormap LUTs, float32 [256, 3] each."""
    z = _lut_file()
    return z["plasma"], z["vorticity"]


def colormap_lut(name: str):
    """(LUT [256, 3], under, over, bad) of the shipped colormap ``name``,
    float32, as matplotlib samples them (its ``_lut`` rows and its
    ``get_under``, ``get_over`` and ``get_bad`` colours)."""
    z = _lut_file()
    under, over, bad = z[name + "_extremes"]
    return z[name], under, over, bad


def build_render_luts(path: str = LUTS_PATH) -> None:
    """Sample the host composer's colormaps (matplotlib's plasma and RdBu_r
    and viz.colorize.vorticity_cmap) at 256 points, with their under, over
    and bad colours, into ``path``, the file ``render_luts`` and
    ``colormap_lut`` read. Needs matplotlib; run it when a colormap
    changes: ``python -c "from lbm2d_tpu_torch.ops.render import
    build_render_luts; build_render_luts()"``."""
    from matplotlib import colormaps

    from ..viz.colorize import vorticity_cmap

    x = np.arange(256) / 255.0
    maps = {"plasma": colormaps["plasma"], "vorticity": vorticity_cmap(),
            "RdBu_r": colormaps["RdBu_r"]}
    out = {}
    for name, cmap in maps.items():
        out[name] = np.asarray(cmap(x)[:, :3], np.float32)
        out[name + "_extremes"] = np.asarray(
            [cmap.get_under()[:3], cmap.get_over()[:3], cmap.get_bad()[:3]], np.float32)
    np.savez_compressed(path, **out)


def _symmetric_np(n: int, radius: int) -> np.ndarray:
    """Indices of numpy's 'symmetric' padding of an axis of length n."""
    i = np.arange(-radius, n + radius)
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - i - 1, i)


def _symmetric_index(n: int, radius: int, device) -> torch.Tensor:
    return torch.as_tensor(_symmetric_np(n, radius), device=device)


def _smooth(a: torch.Tensor, kern, radius: int) -> torch.Tensor:
    """Separable gaussian with scipy's 'reflect' boundary ([H, W])."""
    h, w = a.shape
    ap = a.index_select(0, _symmetric_index(h, radius, a.device))
    acc = 0
    for i in range(2 * radius + 1):
        acc = acc + kern[i] * ap[i : i + h, :]
    ap = acc.index_select(1, _symmetric_index(w, radius, a.device))
    acc = 0
    for i in range(2 * radius + 1):
        acc = acc + kern[i] * ap[:, i : i + w]
    return acc


def _gradient(a: torch.Tensor, axis: int) -> torch.Tensor:
    """np.gradient: central differences, one-sided at the edges."""
    n = a.shape[axis]
    upper = torch.roll(a, -1, axis) - torch.roll(a, 1, axis)
    out = 0.5 * upper
    lo = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    hi = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    out.narrow(axis, 0, 1).copy_(lo)
    out.narrow(axis, n - 1, 1).copy_(hi)
    return out


def _colorize(field, vmin: float, vmax: float, lut: torch.Tensor, mask) -> torch.Tensor:
    """[H, W] scalars -> [H, W, 3] via a 256-LUT; solid cells grey 0.5."""
    norm = (field - vmin) / (vmax - vmin)
    idx = torch.clamp(torch.floor(norm * 256.0), 0, 255).long()
    rgb = lut[idx]
    return torch.where((mask > 0.5)[:, :, None], torch.full_like(rgb, 0.5), rgb)


def _linear_np(n: int, target: int):
    """(lo, hi, w_hi f32) of cv2.INTER_LINEAR from n to ``target`` samples:
    output i is a[lo] (1 - w_hi) + a[hi] w_hi, edge-clamped."""
    src = (np.arange(target) + 0.5) * (n / target) - 0.5
    lo = np.clip(np.floor(src).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    w_hi = np.clip(src - np.floor(src), 0.0, 1.0).astype(np.float32)
    w_hi = np.where(src < 0, 0.0, w_hi).astype(np.float32)  # edge clamp
    return lo, hi, w_hi


def _resize_axis(img: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    """cv2.INTER_LINEAR-convention bilinear along one axis."""
    n = img.shape[axis]
    if n == target:
        return img
    lo, hi, w_hi = _linear_np(n, target)
    shape = [1] * img.dim()
    shape[axis] = target
    w_hi_b = torch.as_tensor(w_hi, device=img.device).reshape(shape)
    a_lo = img.index_select(axis, torch.as_tensor(lo, device=img.device))
    a_hi = img.index_select(axis, torch.as_tensor(hi, device=img.device))
    return a_lo * (1.0 - w_hi_b) + a_hi * w_hi_b


def _rgb_to_i420(rgb8f: torch.Tensor):
    """float [H, W, 3] with integer values 0..255 -> (Y u8 [H, W], UV u8
    [H/2, W/2, 2]), matching cv2.COLOR_RGB2YUV_I420 (BT.601 limited range,
    top-left chroma siting). H and W must be even."""
    r, g, b = rgb8f[..., 0], rgb8f[..., 1], rgb8f[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) * (1.0 / 255.0)
    rs, gs, bs = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = (-37.797 * rs - 74.203 * gs + 112.0 * bs) * (1.0 / 255.0) + 128.0
    v = (112.0 * rs - 93.786 * gs - 18.214 * bs) * (1.0 / 255.0) + 128.0

    def quant(a):
        return torch.clamp(torch.round(a), 0.0, 255.0).to(torch.uint8)

    return quant(y), torch.stack([quant(u), quant(v)], dim=-1)


# the kernel's output tiles (rows x columns of frame pixels), tried in order:
# the first whose largest source footprint fits a block's shared memory
RENDER_TILES = ((16, 32), (8, 32), (8, 16), (4, 16), (4, 8), (2, 8), (2, 4), (1, 4), (1, 2),
                (1, 1))
RENDER_SMEM_MAX = 232_448  # an H100 block's dynamic shared memory, bytes


def _radius(viz_sigma: float) -> int:
    return int(4.0 * viz_sigma + 0.5)


def _axis_np(n: int, target: int):
    """(lo, hi, w_hi, 1 - w_hi) of the resize along an axis, the identity
    (lo = hi, not read by the kernel) where the size is kept."""
    if n == target:
        idx = np.arange(n)
        zero = np.zeros(n, np.float32)
        return idx, idx, zero, zero + np.float32(1.0)
    lo, hi, w_hi = _linear_np(n, target)
    return lo, hi, w_hi, np.float32(1.0) - w_hi


def _tile_plan(H: int, W: int, gui_h: int, gui_w: int, radius: int, smooth: bool):
    """(tile rows, tile columns, shared bytes) of the kernel: the first of
    ``RENDER_TILES`` whose largest footprint (csrc/render.cu: stacked rows
    and grid columns, one more each side, and the gaussian's column halo)
    fits ``RENDER_SMEM_MAX``."""
    ylo, yhi = _axis_np(2 * H, gui_h)[:2]
    xlo, xhi = _axis_np(W, gui_w)[:2]
    hh = (gui_h + 1) // 2
    taps = 2 * radius + 1

    def most(lo, hi, n, spans, size):
        out = 0
        for start, end in spans:
            a = np.arange(start, end, size)
            if a.size:
                b = np.minimum(a + size, end) - 1
                out = max(out, int((np.minimum(hi[b] + 1, n - 1) - np.maximum(lo[a] - 1, 0)).max()) + 1)
        return out

    for th, tw in RENDER_TILES:
        nsr = most(ylo, yhi, 2 * H, ((0, hh), (hh, gui_h)), th)
        nsc = most(xlo, xhi, W, ((0, gui_w),), tw)
        floats = 2 * nsr * nsc + (taps + 2 * nsr * (nsc + 2 * radius) if smooth else 0)
        if 4 * floats <= RENDER_SMEM_MAX:
            return th, tw, 4 * floats
    raise ValueError(f"the render kernel's smallest tile needs {4 * floats} B of shared memory "
                     f"(gaussian radius {radius}), above {RENDER_SMEM_MAX}")


def _tables_np(H: int, W: int, gui_h: int, gui_w: int, viz_sigma: float):
    """(ints, floats) of the kernel's tables, in csrc/render.cu's order:
    the padding indices (with smoothing), the resize's lo and hi of the
    stacked rows and of the columns; the gaussian's taps (with smoothing),
    w and 1 - w of the rows and of the columns, the two LUTs."""
    if H < 2 or W < 2:
        raise ValueError(f"the vorticity's one-sided differences need 2 cells an axis, got "
                         f"{H}x{W}")
    ints, floats = [], []
    if viz_sigma > 0:
        radius = _radius(viz_sigma)
        for n in (H, W):
            pad = _symmetric_np(n, radius)
            if pad.min() < 0 or pad.max() >= n:
                raise ValueError(f"the gaussian's radius {radius} is beyond the 'symmetric' "
                                 f"padding of {n} cells")
            ints.append(pad)
        floats.append(_gaussian_kernel1d(viz_sigma, radius).astype(np.float32))
    rows, cols = _axis_np(2 * H, gui_h), _axis_np(W, gui_w)
    ints += [rows[0], rows[1], cols[0], cols[1]]
    floats += [rows[2], rows[3], cols[2], cols[3], *(lut.reshape(-1) for lut in render_luts())]
    return (np.concatenate(ints).astype(np.int32),
            np.concatenate([np.asarray(f, np.float32) for f in floats]))


@functools.lru_cache(maxsize=64)
def _kernel_tables(device: torch.device, H: int, W: int, gui_h: int, gui_w: int,
                   viz_sigma: float):
    """The kernel's tables on ``device`` and its launch plan, made once a
    process a shape and device (the copies wait on the stream once)."""
    ints, floats = _tables_np(H, W, gui_h, gui_w, viz_sigma)
    smooth = viz_sigma > 0
    radius = _radius(viz_sigma) if smooth else 0
    plan = _tile_plan(H, W, gui_h, gui_w, radius, smooth)
    return (torch.as_tensor(ints, device=device), torch.as_tensor(floats, device=device),
            radius, smooth) + plan


def _render_cuda(u, mask, gui_w, gui_h, viz_sigma, ranges, yuv420):
    """The frames of u [B, 2, H, W] and mask [B, H, W] (float32, one CUDA
    device, any strides) in one launch of csrc/render.cu on the device's
    current stream: RGB u8 [B, gui_h, gui_w, 3], or (Y [B, He, We], UV [B,
    He/2, We/2, 2]). Raises where the kernel cannot take the inputs or the
    launch fails; no sync."""
    from . import cuda_build

    if u.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError(f"the render kernel takes float32 u and mask, got {u.dtype} and "
                         f"{mask.dtype}")
    if u.dim() != 4 or u.shape[1] != 2 or tuple(mask.shape) != (u.shape[0],) + tuple(u.shape[2:]):
        raise ValueError(f"the render kernel takes u [B, 2, H, W] and mask [B, H, W], got "
                         f"{tuple(u.shape)} and {tuple(mask.shape)}")
    if mask.device != u.device:
        raise ValueError(f"u on {u.device}, mask on {mask.device}")
    B, _, H, W = u.shape
    if not 0 < B <= 65535:
        raise ValueError(f"the render kernel takes 1 to 65535 cases a launch, got {B}")
    itab, ftab, radius, smooth, tile_h, tile_w, smem = _kernel_tables(
        u.device, H, W, gui_h, gui_w, float(viz_sigma))
    rec_h, rec_w = gui_h - gui_h % 2, gui_w - gui_w % 2
    if yuv420:
        out0 = torch.empty((B, rec_h, rec_w), dtype=torch.uint8, device=u.device)
        out1 = torch.empty((B, rec_h // 2, rec_w // 2, 2), dtype=torch.uint8, device=u.device)
        outs = (out0, out1)
    else:
        out0 = out1 = torch.empty((B, gui_h, gui_w, 3), dtype=torch.uint8, device=u.device)
        outs = out0
    if out0.numel() == 0:
        return outs
    strides = (ctypes.c_longlong * 7)(*u.stride(), *mask.stride())
    with torch.cuda.device(u.device):
        rc = cuda_build.load("render")(
            u.data_ptr(), mask.data_ptr(), out0.data_ptr(), out1.data_ptr(), itab.data_ptr(),
            ftab.data_ptr(), strides, ranges, B, H, W, gui_h, gui_w, radius, int(smooth),
            int(bool(yuv420)), tile_h, tile_w, smem, torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"render launch failed: CUDA error {rc}")
    return outs


def make_device_frame_renderer(
    gui_w: int,
    gui_h: int,
    viz_sigma: float = 1.0,
    u_norm_max: float = 0.15,
    vorticity_range: float = 0.03,
    batched: bool = False,
    yuv420: bool = False,
    plain: bool = False,
):
    """(u, mask) -> uint8 RGB frame [gui_h, gui_w, 3] on u's device.

    ``u`` is [2, H, W] ([B, 2, H, W] when batched), mask [H, W] ([B, H, W]).
    gui_w/gui_h come from viz.frames.calc_gui_size (gui_h is the doubled
    two-panel height). The frame is unflipped and uncropped:
    io.video.VideoRecorder.write_frame_u8 applies the even-dim crop,
    vertical flip and BGR swap.

    ``yuv420``: return (Y u8 [He, We], UV u8 [He/2, We/2, 2]) instead, He/We
    being gui_h/gui_w clamped to even (the recorder's crop, applied here):
    half the device-to-host bytes of the RGB frame, pixel-matching
    cv2.COLOR_RGB2YUV_I420 of it to 1 lsb.

    On CUDA tensors one launch of the render kernel makes the frames of all
    the call's cases (counted in ``cuda_build.CALLS["render"]``); on CPU
    tensors, or with ``plain``, the plain torch ops run on any device.
    """
    radius = _radius(viz_sigma)
    kern_np = _gaussian_kernel1d(viz_sigma, radius).astype(np.float32) if viz_sigma > 0 else None
    plasma_np, vort_np = render_luts()
    rec_h = gui_h - 1 if gui_h % 2 else gui_h
    rec_w = gui_w - 1 if gui_w % 2 else gui_w
    consts = {}
    # vmin and 1 / (vmax - vmin) of each panel in f32: torch's CUDA division
    # by a host scalar multiplies by its reciprocal, taken in double and
    # rounded to f32
    ranges = (ctypes.c_float * 4)(*(float(np.float32(x)) for x in (
        0.0, 1.0 / (u_norm_max - 0.0), -vorticity_range,
        1.0 / (vorticity_range - (-vorticity_range)))))

    def on(device):
        if device not in consts:
            consts[device] = (
                None if kern_np is None else torch.as_tensor(kern_np, device=device),
                torch.as_tensor(plasma_np, device=device),
                torch.as_tensor(vort_np, device=device),
            )
        return consts[device]

    def render_one(u: torch.Tensor, mask: torch.Tensor):
        kern, plasma, vort_lut = on(u.device)
        ux, uy = u[0], u[1]
        if viz_sigma > 0:
            ux = _smooth(ux, kern, radius)
            uy = _smooth(uy, kern, radius)
        vel_mag = torch.sqrt(ux * ux + uy * uy)
        # reference viz sign convention: du/dy - dv/dx (viz/frames.py)
        vor = _gradient(ux, 0) - _gradient(uy, 1)
        vel_img = _colorize(vel_mag, 0.0, u_norm_max, plasma, mask)
        vor_img = _colorize(vor, -vorticity_range, vorticity_range, vort_lut, mask)
        img = torch.cat([vel_img, vor_img], dim=0)  # [2H, W, 3]
        img = _resize_axis(img, gui_h, 0)
        img = _resize_axis(img, gui_w, 1)
        rgb8f = torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0)
        if yuv420:
            return _rgb_to_i420(rgb8f[:rec_h, :rec_w, :])
        return rgb8f.to(torch.uint8)

    @torch.no_grad()
    def render(u: torch.Tensor, mask: torch.Tensor):
        if u.is_cuda and not plain:
            if batched:
                return _render_cuda(u, mask, gui_w, gui_h, viz_sigma, ranges, yuv420)
            out = _render_cuda(u[None], mask[None], gui_w, gui_h, viz_sigma, ranges, yuv420)
            return tuple(t[0] for t in out) if yuv420 else out[0]
        if not batched:
            return render_one(u, mask)
        frames = [render_one(u[b], mask[b]) for b in range(u.shape[0])]
        if yuv420:
            return torch.stack([y for y, _ in frames]), torch.stack([uv for _, uv in frames])
        return torch.stack(frames)

    return render
