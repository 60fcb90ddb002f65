"""The port's Bouzidi q planes (``core/solver.bouzidi_q_planes``), which
search the wall on the link cells only, against the JAX package's
all-cell evaluation on a mask of the production generator: bitwise, for
the mask's own signed distance (``{"shape": "sdf"}``, the production
masks' geometry) and for the generator's analytic shapes (a union). The
six single-shape cases are in ``test_torch_bouzidi.py``.
"""

import copy
import os
import random

import numpy as np
import pytest
import yaml

from lbm2d_tpu.core import solver as js
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.tools.map_generators import HybridMapGenerator
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5


@pytest.fixture(scope="module")
def hybrid():
    """(mask, analytic geometry) of a 128 x 256 hybrid mask, seed 5."""
    with open(os.path.join(REPO, "master_config.yaml")) as fh:
        cfg = yaml.safe_load(fh)["map_generator"]
    cfg["domain"] = {"width": 256, "height": 128}
    cfg["validation"]["boundary_buffer"] = 8
    cfg["step_urban"]["rect_size"] = {"w": [8, 24], "h": [8, 24]}
    cfg["step_urban"]["min_distance"] = [3, 6]
    g = HybridMapGenerator(cfg, random.Random(SEED))
    g.generate()
    return g.grid.astype(np.float32), {"shape": "union", "parts": copy.deepcopy(g.geoms)}


@pytest.mark.parametrize("kind", ["sdf", "geoms"])
def test_q_planes_on_a_generator_mask_equal_jax_bitwise(hybrid, kind):
    mask, union = hybrid
    assert mask.shape == (128, 256) and 0.02 < mask.mean() < 0.5
    assert len(union["parts"]) >= 5
    geom = {"shape": "sdf"} if kind == "sdf" else union
    a = ts.bouzidi_q_planes(mask, copy.deepcopy(geom))
    b = js.bouzidi_q_planes(mask, copy.deepcopy(geom))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert (a != 0.5).sum() >= 100  # real sub-grid fractions, not just the fallback
