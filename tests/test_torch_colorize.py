"""The port's colorize (shipped LUTs, no matplotlib) against the JAX
package's (matplotlib), bitwise, on seeded fields with masked cells, NaN
and values outside the colour range."""

import subprocess
import sys

import numpy as np
import pytest

from lbm2d_tpu.viz import colorize as jax_colorize
from lbm2d_tpu_torch.viz import colorize as port_colorize


def _field(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, shape)
    x[3, :5] = np.nan
    x[7, 7] = np.inf
    x[8, 8] = -np.inf
    x[9, :4] = [0.0, 1.0, -1.0, 0.3]  # the range's ends hit exactly
    mask = (rng.uniform(size=shape) < 0.15).astype(np.float32)
    return x.astype(np.float32), mask


CASES = [
    ("velocity", lambda m, x, k: m.colorize_velocity(np.abs(x), 1.0, k)),
    ("velocity_nomask", lambda m, x, k: m.colorize_velocity(np.abs(x), 0.3)),
    ("vorticity", lambda m, x, k: m.colorize_vorticity(x, 1.0, k)),
    ("vorticity_nomask", lambda m, x, k: m.colorize_vorticity(x, 0.05)),
    ("pressure", lambda m, x, k: m.colorize_pressure(x, -0.2, 0.7, k)),
    ("pressure_flat_range", lambda m, x, k: m.colorize_pressure(x, 0.5, 0.5, k)),
]


@pytest.mark.parametrize("name,call", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_colorize_matches_matplotlib_bitwise(name, call, seed):
    x, mask = _field(seed)
    want = call(jax_colorize, x, mask)
    got = call(port_colorize, x, mask)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_reversed_range_raises_like_matplotlib():
    x, _ = _field(0)
    with pytest.raises(ValueError):
        jax_colorize.colorize_pressure(x, 1.0, 0.0)
    with pytest.raises(ValueError):
        port_colorize.colorize_pressure(x, 1.0, 0.0)


def test_serial_composer_runs_without_matplotlib():
    # the serial path's video: FrameComposer -> colorize, with matplotlib
    # made unimportable
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "from lbm2d_tpu_torch.viz.frames import FrameComposer\n"
        "u = np.random.default_rng(0).normal(0, 0.05, (2, 32, 64)).astype(np.float32)\n"
        "mask = np.zeros((32, 64), np.float32); mask[10:14, 20:24] = 1\n"
        "img = FrameComposer(64, 64).process_frame(u, mask)\n"
        "assert np.isfinite(img).all(), img\n"
        "bad = [m for m in sys.modules if m.startswith('matplotlib') and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
