"""The control: the reference in the program's place at the precision
below the configuration's comes out not correct, and the program correct.

On the CPU at a tiny size; on the card (``-m cuda``) at the cells' own
sizes on three seeds, the run that the limits' upper readings come from."""

import pytest

from lbmbench import control
from lbmbench.tests import tiny


def tiny_overrides(kind):
    def over(config, wl):
        if kind == "dfg":
            return tiny.dfg()
        return tiny.urban(wl["record"])
    return over


@pytest.mark.parametrize("cell,kind", [("urban5.prod", "urban"), ("urban5.norecord", "urban"),
                                        ("dfg.re100", "dfg")])
def test_control_fails_and_program_passes_tiny(cell, kind):
    (line,) = control.readings(cell, [2**31 + 5], 0.1, device="cpu",
                               overrides=tiny_overrides(kind))
    assert line["program_correct"], line
    assert not line["control_correct"], line


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's readings at the cells' sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["urban5.prod", "urban5.norecord", "dfg.re100"])
def test_control_fails_at_cell_size(card, cell):
    lines = list(control.readings(cell, [11, 12, 13], 1.0))
    for line in lines:
        assert line["program_correct"], line
        assert not line["control_correct"], line
