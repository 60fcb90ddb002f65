"""The render kernel (``csrc/render.cu``) behind ``ops/render``'s device
frame renderer: on CUDA tensors one launch a call over all the call's
cases, bitwise the plain torch render on the card; on CPU tensors the plain
torch render itself.

``cuda`` tests hold the kernel to its plain version on the card and skip
here; on the card they run with ``--noconftest -m cuda``. This file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.ops import cuda_build, render
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


def _field(B, H, W, seed):
    """A seeded velocity field [B, 2, H, W] and masks [B, H, W] with solid
    cells on the grid's edges (so on both sides of the panel seam: row H - 1
    of the |u| panel, row 0 of the vorticity panel) and inside."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    u = np.empty((B, 2, H, W), np.float32)
    for b in range(B):
        u[b, 0] = 0.08 * np.sin(2 * np.pi * yy / H + b) + 0.03 * rng.standard_normal((H, W))
        u[b, 1] = 0.05 * np.cos(2 * np.pi * xx / W - b) + 0.03 * rng.standard_normal((H, W))
    mask = (rng.uniform(size=(B, H, W)) < 0.08).astype(np.float32)
    mask[:, 0, : W // 3] = 1.0
    mask[:, H - 1, W // 2 :] = 1.0
    mask[:, :, 0] = 1.0
    mask[:, H // 3 : H // 3 + 3, W - 1] = 1.0
    return u, mask


def _bin_edges(n: int, vmin: float, vmax: float) -> np.ndarray:
    """f32 values in [vmin, vmax) at which the colour index
    floor(256 (v - vmin) / (vmax - vmin)) of the plain render on the card
    (a multiply by the reciprocal taken in double and rounded to f32)
    differs from the same with the reciprocal taken in f32, or with a true
    f32 division: a kernel that did either would land one LUT entry off
    there."""
    f32 = np.float32
    lo, span = f32(vmin), vmax - vmin
    inv_d, inv_f = f32(1.0 / span), f32(1.0) / f32(span)
    out = []
    for k in range(1, 256):
        x = f32(vmin + k * span / 256)
        for _ in range(64):
            for v in (x, np.nextafter(x, f32(-1))):
                t = f32(v - lo)
                idx = [np.floor(f32(f32(t * i) * f32(256))) for i in (inv_d, inv_f)]
                idx.append(np.floor(f32(f32(t / f32(span)) * f32(256))))
                if idx[0] != idx[1] or idx[0] != idx[2]:
                    out.append(v)
            x = np.nextafter(x, f32(1))
        if len(out) >= n:
            break
    return np.asarray(out[:n], np.float32)


# (B, H, W, gui_h, gui_w, viz_sigma): even and odd widths, odd frame sizes,
# the production shrink ratio, an enlargement, both sizes kept
SHAPES = [
    (1, 48, 96, 41, 81, 1.0),
    (5, 47, 97, 39, 41, 1.0),
    (5, 64, 135, 57, 60, 0.0),
    (1, 30, 45, 75, 91, 1.0),
    (2, 40, 60, 80, 60, 0.0),
    (5, 115, 243, 97, 102, 1.0),
]


@pytest.mark.parametrize("yuv", [False, True], ids=["rgb", "i420"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_cpu_tensors_take_the_plain_render(shape, yuv):
    B, H, W, gui_h, gui_w, sigma = shape
    u, mask = (torch.from_numpy(a) for a in _field(B, H, W, B + H + W))
    kw = dict(viz_sigma=sigma, batched=True, yuv420=yuv)
    out = render.make_device_frame_renderer(gui_w, gui_h, **kw)(u, mask)
    ref = render.make_device_frame_renderer(gui_w, gui_h, plain=True, **kw)(u, mask)
    for a, b in zip(out if yuv else (out,), ref if yuv else (ref,)):
        assert torch.equal(a, b)
    calls = dict(cuda_build.CALLS)
    render.make_device_frame_renderer(gui_w, gui_h, **kw)(u, mask)
    assert cuda_build.CALLS == calls  # no launch for a CPU tensor


def test_build_table_holds_the_render_library():
    assert cuda_build.SOURCES["render"] == "render.cu"
    lib, entry, argtypes = cuda_build.KERNELS["render"]
    assert (lib, entry) == ("render", "render_launch")
    with open(f"{cuda_build.CSRC}/render.cu") as fh:
        src = fh.read()
    sig = src[src.index('extern "C" int render_launch('):]
    sig = sig[: sig.index(")")]
    assert sig.count(",") + 1 == len(argtypes) == 20
    assert "-fmad=false" in cuda_build.NVCC_FLAGS


def test_tables_follow_the_kernels_layout():
    H, W, gui_h, gui_w, sigma = 1152, 2432, 970, 1024, 1.0
    ints, floats = render._tables_np(H, W, gui_h, gui_w, sigma)
    r = render._radius(sigma)
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert ints.size == (H + 2 * r) + (W + 2 * r) + 2 * gui_h + 2 * gui_w
    assert floats.size == (2 * r + 1) + 2 * gui_h + 2 * gui_w + 2 * 256 * 3
    # the production frame: 16 x 32 pixel tiles of ~55 kB, four blocks a SM
    th, tw, smem = render._tile_plan(H, W, gui_h, gui_w, r, True)
    assert (th, tw) == (16, 32) and smem <= render.RENDER_SMEM_MAX // 4
    # without smoothing the taps and padding tables are left out
    ints0, floats0 = render._tables_np(H, W, gui_h, gui_w, 0.0)
    assert ints0.size == 2 * gui_h + 2 * gui_w and floats0.size == floats.size - (2 * r + 1)


def test_the_kernel_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="2 cells an axis"):
        render._tables_np(1, 64, 2, 64, 1.0)
    with pytest.raises(ValueError, match="radius 120"):
        render._tables_np(100, 100, 50, 50, 30.0)
    # the inputs are checked before anything is launched
    u = torch.zeros((1, 2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 u and mask"):
        render._render_cuda(u, torch.zeros((1, 8, 8)), 8, 16, 1.0, None, False)
    with pytest.raises(ValueError, match=r"u \[B, 2, H, W\]"):
        render._render_cuda(u.float()[:, :1], torch.zeros((1, 8, 8)), 8, 16, 1.0, None, False)


def test_bin_edges_separate_the_reciprocals_and_the_division():
    for vmin, vmax in ((0.0, 0.15), (-0.03, 0.03)):
        edges = _bin_edges(16, vmin, vmax)
        assert edges.size == 16 and (edges >= vmin).all() and (edges < vmax).all()


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b, tag):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.uint8, tag
    diff = (a.int() - b.int()).abs()
    assert torch.equal(a, b), f"{tag}: {int((diff > 0).sum())} bytes differ, by up to {int(diff.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("yuv", [False, True], ids=["rgb", "i420"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_is_bitwise_its_plain_version(cuda_dev, shape, yuv):
    B, H, W, gui_h, gui_w, sigma = shape
    u, mask = _field(B, H, W, 7 * B + H + W)
    if sigma == 0 and (gui_h, gui_w) == (2 * H, W):
        # frame pixels are grid cells: in every case plant, along row 1,
        # speeds on the |u| colour index's reciprocal edges, and along row 4
        # vorticities on its own (du/dy = (2v - 0) / 2 = v, dv/dx = 0)
        speeds, vorts = _bin_edges(W - 2, 0.0, 0.15), _bin_edges(W - 2, -0.03, 0.03)
        u[:, :, 1:6] = 0.0
        u[:, 0, 1, 1:1 + speeds.size] = speeds
        u[:, 0, 5, 1:1 + vorts.size] = 2 * vorts
        mask[:, 1:6] = 0.0
    u, mask = torch.from_numpy(u).to(cuda_dev), torch.from_numpy(mask).to(cuda_dev)
    kw = dict(viz_sigma=sigma, batched=True, yuv420=yuv)
    calls = cuda_build.CALLS.get("render", 0)
    out = render.make_device_frame_renderer(gui_w, gui_h, **kw)(u, mask)
    ref = render.make_device_frame_renderer(gui_w, gui_h, plain=True, **kw)(u, mask)
    torch.cuda.synchronize()
    assert cuda_build.CALLS["render"] == calls + 1  # one launch for the B cases
    for k, (a, b) in enumerate(zip(out if yuv else (out,), ref if yuv else (ref,))):
        _same(a, b, f"output {k}")
    # one case unbatched, from a strided u (the columns of a wider field)
    one = render.make_device_frame_renderer(gui_w, gui_h, viz_sigma=sigma, yuv420=yuv)
    wide = torch.cat([u, u], dim=3)[..., :W]
    for k, (a, b) in enumerate(zip(
            one(wide[B - 1], mask[B - 1]) if yuv else (one(wide[B - 1], mask[B - 1]),),
            out if yuv else (out,))):
        _same(a, b[B - 1], f"unbatched output {k}")
