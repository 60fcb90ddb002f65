"""The roofline tool of the port (``tools/roofline.py``), its copy probe
(``ops/copy_probe.py``) and its demo case, on the CPU: the probe's plain
version against ``torch.Tensor.copy_``, the byte accounting against a hand
count, the demo case against the JAX package's entry module. The probe's
kernel itself runs on the card only (``test_torch_cuda_step.py``)."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _cylinder_mask, _demo_config
from lbm2d_tpu_torch.ops import copy_probe as cp
from lbm2d_tpu_torch.tools import demo_case, roofline


@pytest.mark.parametrize("shape", [(16, 24), (7, 9)], ids=["vector", "scalar-tail"])
def test_copy_probe_plain_equals_copy(shape):
    rng = np.random.default_rng(0)
    f = torch.tensor(rng.standard_normal((9,) + shape), dtype=torch.float32)
    # aux carries negative values and -0.0 (solid cells): 0 * aux is +-0
    aux = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    aux[0, 0] = -0.0
    lib = torch.empty_like(f)
    lib.copy_(f)
    for a in (None, aux):
        out = torch.full_like(f, float("nan"))
        before = dict(cp.LAUNCHES)
        cp.copy_probe(f, out, a)
        assert torch.equal(out, lib)
        assert cp.LAUNCHES == before  # CPU tensors never count as launches
    assert cp.variant(None) == "copy_probe" and cp.variant(aux) == "copy_probe_aux"


def test_step_traffic_hand_count():
    t = roofline.step_traffic(4096, 4096)
    cells = 4096 * 4096
    # f 9 x 4 B read and written (the ring is written by K1 itself, no edge
    # export), aux 4 B
    assert t["f_in"] == t["f_out"] == 36 * cells and t["aux"] == 4 * cells
    assert set(t) == {"f_in", "f_out", "aux", "total", "per_cell"}
    assert t["total"] == 76 * cells
    assert t["per_cell"] == pytest.approx(76.0, abs=0)
    assert roofline.copy_traffic(4096, 4096, aux=False) == 72 * cells
    assert roofline.copy_traffic(4096, 4096, aux=True) == 76 * cells


def test_demo_case_matches_entry_module():
    for nx, ny, kw in ((4096, 4096, dict(nu=0.01, warmup=2000)), (64, 32, {})):
        assert demo_case.demo_config(nx, ny, **kw) == _demo_config(nx, ny, **kw)
        np.testing.assert_array_equal(demo_case.cylinder_mask(ny, nx), _cylinder_mask(ny, nx))


def test_roofline_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.measure(64, 1, 2)
    assert roofline.main(["64", "1", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
