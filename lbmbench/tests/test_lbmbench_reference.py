"""The plain reference: its collision holds rest at rest and conserves mass
and momentum on a periodic grid, and its step is the program's eager step
(the port's own plain version) on small seeded cases in float64."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from lbmbench import masks
from lbmbench.reference import frames, lbm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def periodic_case(ny=16, nx=24):
    cfg = {"simulation": {"nx": nx, "ny": ny, "nu": 0.02, "ghost_moments_s": 1.2,
                          "rho_in": 1.0, "rho_out": 1.0, "smagorinsky_constant": 0.1,
                          "warmup_steps": 10},
           "boundary_condition": {"type": [1, 1, 1, 1], "value": [[0, 0]] * 4},
           "domain_zones": {"sponge_in": 1, "sponge_out": 1, "sponge_top": 1,
                            "sponge_bot": 1, "sponge_strength": 0.0}}
    return lbm.make_case(cfg, np.zeros((ny, nx)))


def test_rest_stays_at_rest():
    case = periodic_case()
    f = lbm.rest_state(16, 24)["f"]
    f_star, rho, ux, uy = lbm.collide(lbm.stream(f), case)
    assert torch.equal(rho, torch.ones_like(rho)) or float((rho - 1).abs().max()) < 1e-15
    assert float((f_star - f).abs().max()) < 1e-15
    assert float(ux.abs().max()) < 1e-15 and float(uy.abs().max()) < 1e-15


def test_periodic_conserves_mass_and_momentum():
    case = periodic_case()
    g = torch.Generator().manual_seed(3)
    rho = 1 + 0.01 * torch.rand(16, 24, generator=g, dtype=torch.float64)
    ux = 0.05 * torch.rand(16, 24, generator=g, dtype=torch.float64)
    uy = 0.02 * torch.rand(16, 24, generator=g, dtype=torch.float64)
    f = lbm.equilibrium(rho, ux, uy)
    mass = float(f.sum())
    mom = [float((f * torch.tensor(e, dtype=f.dtype).reshape(9, 1, 1)).sum())
           for e in (lbm.EX, lbm.EY)]
    for _ in range(20):
        f = lbm.collide(lbm.stream(f), case)[0]
    assert abs(float(f.sum()) - mass) < 1e-11
    for e, m0 in zip((lbm.EX, lbm.EY), mom):
        assert abs(float((f * torch.tensor(e, dtype=f.dtype).reshape(9, 1, 1)).sum()) - m0) < 1e-11


def small_urban(seed=5):
    cfg = json.load(open(os.path.join(ROOT, "lbmbench", "configs",
                                      "urban_2432x1152_lockstep5.json")))["case"]
    cfg = copy.deepcopy(cfg)
    cfg["simulation"].update(nx=192, ny=96, nu=0.02, warmup_steps=30)
    cfg["domain_zones"].update(sponge_in=8, sponge_out=32, sponge_top=4, sponge_bot=4, buffer=8)
    cfg["outputs"]["dataset"]["save_resolution_height"] = 24
    mask = masks.urban_mask(seed, {"width": 128, "height": 64},
                            {"left": 16, "right": 48, "top": 16, "bot": 16})
    return cfg, mask


def test_step_is_the_programs_eager_step():
    from lbm2d_tpu_torch.core import solver

    cfg, mask = small_urban()
    p = solver.make_params(cfg, mask, dtype=torch.float64)
    st = solver.init_state(*mask.shape, torch.float64)
    case = lbm.make_case(cfg, mask)
    ref = lbm.rest_state(*mask.shape)
    for i in range(40):
        st = solver.step(st, p)
        ref = lbm.step(ref, i + 1, case)
    for k in ("f", "f_post", "rho", "u"):
        assert float((getattr(st, k) - ref[k]).abs().max()) < 1e-13, k
    assert float((solver.obstacle_force(st.f_post, p)
                  - lbm.force_equilibrium(ref["f_post"], case.solid)).abs().max()) < 1e-12


def test_bouzidi_nebb_is_the_programs_eager_step():
    from lbm2d_tpu_torch.analysis.dfg_validation import dfg_case
    from lbm2d_tpu_torch.core import solver

    from lbmbench import harness

    drv = harness.load_module(os.path.join(ROOT, "lbmbench", "drivers", "dfg_validation.py"),
                              "dfg_driver_for_test")
    cfg, mask = drv.case_of({"validation": {"ny": 25, "u_target": 0.1, "re": 100.0}})
    cfg_p, mask_p, _ = dfg_case(ny=25, u_max=0.1, re=100.0, obstacle="bounce_back_bouzidi",
                                inlet="nebb")
    assert np.array_equal(mask, mask_p)
    cfg["simulation"]["warmup_steps"] = cfg_p["simulation"]["warmup_steps"] = 40
    p = solver.make_params(cfg_p, mask_p, dtype=torch.float64)
    case = lbm.make_case(cfg, mask)
    assert np.abs(p.bouzidi_q.numpy() - case.bouzidi_q.numpy()[1:]).max() == 0
    st = solver.init_state(*mask.shape, torch.float64)
    ref = lbm.rest_state(*mask.shape)
    for i in range(40):
        st = solver.step(st, p)
        ref = lbm.step(ref, i + 1, case)
    assert float((st.f - ref["f"]).abs().max()) < 1e-13
    cyl = torch.as_tensor(mask_p, dtype=torch.float64)
    assert float((solver.obstacle_force(st.f_post, p, mask=cyl) - lbm.force_bouzidi(
        ref["f_post"], case.solid, case.bouzidi_q)).abs().max()) < 1e-12


def test_frames_are_the_programs_resize_and_render():
    from lbm2d_tpu_torch.core.lattice import moments_from_f
    from lbm2d_tpu_torch.ops.render import make_device_frame_renderer
    from lbm2d_tpu_torch.ops.resize import make_device_resizer

    cfg, mask = small_urban()
    case = lbm.make_case(cfg, mask)
    ref = lbm.rest_state(*mask.shape)
    for i in range(40):
        ref = lbm.step(ref, i + 1, case)
    ys, xs, th, tw = frames.crop_box(cfg)
    m = moments_from_f(ref["f_post"].float())[:, ys, xs]
    got = make_device_resizer(m.shape[1], m.shape[2], th, tw)(m).double()
    want = frames.dataset_frame(ref["f_post"], cfg)
    assert float((got - want).abs().max()) < 1e-6
    gw, gh = frames.gui_size(cfg["simulation"]["nx"], cfg["simulation"]["ny"], 1024)
    y, uv = make_device_frame_renderer(gw, gh, 1.0, yuv420=True)(ref["u"].float(),
                                                                  case.solid.float())
    ry, ruv = frames.video_frame(ref["u"], case.solid, cfg)
    assert y.shape == ry.shape and uv.shape == ruv.shape
    diff = torch.cat([(y.int() - ry.int()).abs().flatten(), (uv.int() - ruv.int()).abs().flatten()])
    # rounding moves pixels on a colormap boundary by one level, no more
    assert float((diff > 1).double().mean()) < 1e-3


@pytest.mark.parametrize("store", [torch.float8_e4m3fn, torch.bfloat16])
def test_lower_storage_departs(store):
    cfg, mask = small_urban()
    case = lbm.make_case(cfg, mask)
    exact = lbm.chunk(lbm.rest_state(*mask.shape), 0, 40, case)
    low = lbm.chunk(lbm.rest_state(*mask.shape), 0, 40, case, store=store)
    assert float((exact["f"] - low["f"]).abs().max()) > 0
