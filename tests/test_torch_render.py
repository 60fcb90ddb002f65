"""The port's device frame renderer and dataset resizer (ops/render.py,
ops/resize.py) against the JAX package's, on the same seeded fields.

Both renderers run the same f32 pipeline (gaussian, |u|, vorticity, LUT,
bilinear resize); the sums are taken in another order, so a value that
sits on a colormap bin edge can land one LUT entry over. The RGB frames
must therefore be byte-equal except at a small fraction of pixels (the
JAX package's own test against the host composer allows 2%); the YUV
planes within 1 lsb; the resizer within 1e-6 (two f32 matmuls, summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm2d_tpu.ops import render as jax_render
from lbm2d_tpu.ops.resize import make_device_resizer as jax_resizer
from lbm2d_tpu_torch.ops import render
from lbm2d_tpu_torch.ops.resize import make_device_resizer, resize_area
from lbm2d_tpu_torch.viz.frames import calc_gui_size

# fraction of RGB bytes allowed to differ (LUT bin edges), and by how much
EDGE_FRACTION = 0.01
EDGE_DIFF = 40


def _field(ny, nx, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    ux = 0.08 * np.sin(2 * np.pi * yy / ny) + 0.02 * rng.standard_normal((ny, nx))
    uy = 0.05 * np.cos(2 * np.pi * xx / nx) + 0.02 * rng.standard_normal((ny, nx))
    u = np.stack([ux, uy]).astype(np.float32)
    mask = np.zeros((ny, nx), np.float32)
    mask[ny // 3 : ny // 3 + 8, nx // 4 : nx // 4 + 8] = 1.0
    return u, mask


def _assert_bytes_close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert np.mean(diff > 0) <= EDGE_FRACTION, np.mean(diff > 0)
    assert diff.max() <= EDGE_DIFF, diff.max()


def test_luts_are_the_matplotlib_samples():
    plasma, vort = render.render_luts()
    np.testing.assert_array_equal(plasma, jax_render._plasma_lut())
    np.testing.assert_array_equal(vort, jax_render._vorticity_lut())


def test_lut_file_is_rebuilt_identically(tmp_path):
    out = str(tmp_path / "luts.npz")
    render.build_render_luts(out)
    with np.load(out) as new, np.load(render.LUTS_PATH) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k])


@pytest.mark.parametrize(
    "ny, nx, max_size, sigma",
    [(96, 160, 128, 1.0), (64, 128, None, 1.0), (48, 100, 64, 2.0)],
    ids=["resized", "native", "sigma-2"],
)
def test_rgb_frame_matches_jax(ny, nx, max_size, sigma):
    u, mask = _field(ny, nx, seed=ny)
    gui_w, gui_h = calc_gui_size(nx, ny, max_size)
    ref = np.asarray(jax_render.make_device_frame_renderer(gui_w, gui_h, viz_sigma=sigma)(
        jnp.asarray(u), jnp.asarray(mask)))
    out = render.make_device_frame_renderer(gui_w, gui_h, viz_sigma=sigma)(
        torch.from_numpy(u), torch.from_numpy(mask)).numpy()
    assert out.shape == (gui_h, gui_w, 3)
    _assert_bytes_close(out, ref)


def test_batched_rgb_equals_per_case():
    ny, nx = 64, 96
    (u0, m0), (u1, m1) = _field(ny, nx, 1), _field(ny, nx, 2)
    gui_w, gui_h = calc_gui_size(nx, ny, None)
    one = render.make_device_frame_renderer(gui_w, gui_h)
    batched = render.make_device_frame_renderer(gui_w, gui_h, batched=True)
    out = batched(torch.from_numpy(np.stack([u0, u1])), torch.from_numpy(np.stack([m0, m1])))
    assert out.shape == (2, gui_h, gui_w, 3)
    for b, (u, m) in enumerate(((u0, m0), (u1, m1))):
        np.testing.assert_array_equal(out[b].numpy(), one(torch.from_numpy(u), torch.from_numpy(m)).numpy())
    # obstacle cells are grey 127 in the velocity panel
    assert out[0, ny // 3 + 2, nx // 4 + 2, 0] == 127


@pytest.mark.parametrize("nx", [96, 97], ids=["even", "odd-width"])
def test_yuv420_matches_jax_within_one_lsb(nx):
    ny = 48
    u, mask = _field(ny, nx, seed=nx)
    gui_w, gui_h = nx, 2 * ny
    y_ref, uv_ref = jax_render.make_device_frame_renderer(
        gui_w, gui_h, yuv420=True, batched=True)(jnp.asarray(u[None]), jnp.asarray(mask[None]))
    y, uv = render.make_device_frame_renderer(gui_w, gui_h, yuv420=True, batched=True)(
        torch.from_numpy(u[None]), torch.from_numpy(mask[None]))
    even_w = gui_w - gui_w % 2
    assert tuple(y.shape) == (1, gui_h, even_w) == np.asarray(y_ref).shape
    assert tuple(uv.shape) == (1, gui_h // 2, even_w // 2, 2) == np.asarray(uv_ref).shape
    assert y.dtype == uv.dtype == torch.uint8
    for a, b in ((y, y_ref), (uv, uv_ref)):
        d = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
        assert d.max() <= 1, d.max()


def test_rgb_to_i420_matches_jax_within_one_lsb():
    rng = np.random.default_rng(3)
    rgb = np.floor(rng.uniform(0, 256, (32, 48, 3))).astype(np.float32)
    y_ref, uv_ref = jax_render._rgb_to_i420(jnp.asarray(rgb))
    y, uv = render._rgb_to_i420(torch.from_numpy(rgb))
    assert np.abs(y.numpy().astype(int) - np.asarray(y_ref).astype(int)).max() <= 1
    assert np.abs(uv.numpy().astype(int) - np.asarray(uv_ref).astype(int)).max() <= 1


@pytest.mark.parametrize(
    "shape, dst",
    [((2, 9, 40, 72), (16, 28)), ((9, 33, 50), (16, 24)), ((3, 10, 12), (16, 20))],
    ids=["batched-shrink", "shrink", "enlarge"],
)
def test_resizer_matches_jax(shape, dst):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    src_h, src_w = shape[-2:]
    ref = np.asarray(jax_resizer(src_h, src_w, *dst)(jnp.asarray(x)))
    out = make_device_resizer(src_h, src_w, *dst)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape[:-2] + dst
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_resizer_of_a_crop_matches_host_area_resize():
    x = np.random.default_rng(9).standard_normal((9, 48, 80)).astype(np.float32)
    crop = (slice(None), slice(5, 41), slice(8, 70))
    out = make_device_resizer(36, 62, 16, 27)(torch.from_numpy(x)[crop]).numpy()
    for c in range(9):
        host = resize_area(np.ascontiguousarray(x[crop][c]), 27, 16)
        np.testing.assert_allclose(out[c], host, rtol=0, atol=1e-5)
    assert not torch.backends.cuda.matmul.allow_tf32

