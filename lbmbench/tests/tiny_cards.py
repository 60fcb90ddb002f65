"""A tiny version of the four-card configuration, for CPU tests: the
grid, depth and masks of ``tiny.urban``, its cases on the CPU named four
times."""

import copy
import os

from lbmbench import harness
from lbmbench.tests import tiny


def urban_cards():
    cfg = copy.deepcopy(harness.load_json(os.path.join(
        tiny.HERE, "configs", "urban_2432x1152_cases20_cards4.json")))
    small, _ = tiny.urban(record=True)
    for key in ("case", "mask"):
        cfg[key] = small[key]
    wl = dict(harness.load_json(os.path.join(tiny.HERE, "workloads", "urban5.case4.json")),
              sample_groups=1, trace_chunks=[3, 6])
    return cfg, wl
