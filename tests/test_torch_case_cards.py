"""The lockstep dataset run over a case mesh of cards, on the CPU, where the
mesh is the CPU named four times: a group of 8 cases on 4 "cards" at
64x1024 (deviation storage engages from 65,536 cells), the README's flags
with the dataset and the video on.

Each card produces its own saves (moments, crop, resize, f16 cast and
render, for its cases), the save stage copies each card's part and the
writers read each case's rows from its part: the artifacts equal the
single-device run's, byte for byte, and no field is gathered between
cards inside the chunk loop (``engine.gather`` records none there)."""

import json
import os

import h5py
import numpy as np
import pytest
import yaml

from lbm2d_tpu_torch.parallel.batch import BatchEngine
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.utils import profiling
from test_pipeline_e2e import make_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

PROJECT = "CardsProj"
NX, NY = 1024, 64
NUS = (0.02, 0.025, 0.03, 0.035, 0.04, 0.045, 0.05, 0.055)
FLAGS = dict(lockstep=True, device_resize=True, max_batch=8, f16_state=True, f16_transfer=True,
             yuv_video=True, f16_retry=True)


def _project(root):
    """8 cases of one mask, dataset and video on."""
    cfg_name = make_project(root, name=PROJECT, nx=NX, ny=NY)
    cfg_dir = os.path.join(root, "SimCases", PROJECT, "configs")
    with open(os.path.join(cfg_dir, cfg_name)) as fh:
        base = yaml.safe_load(fh)
    os.remove(os.path.join(cfg_dir, cfg_name))
    for nu in NUS:
        cfg = json.loads(json.dumps(base))
        tag = f"Nu{nu:.4f}".replace(".", "-")
        cfg["simulation"].update(nu=nu, name=f"mask_00_{tag}")
        cfg["outputs"]["video"].update(enable=True, filename=f"mask_00_{tag}.mp4")
        with open(os.path.join(cfg_dir, f"mask_00_cfg_{tag}.yaml"), "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def _run(tmp_path_factory, tag, **flags):
    root = str(tmp_path_factory.mktemp(tag))
    _project(root)
    profiling.REGISTRY.reset()
    with profiling.REGISTRY.recording():
        stats = run_batch(PROJECT, root=root, progress=False, device="cpu", **FLAGS, **flags)
    assert stats["success"] == len(NUS), stats
    return root, profiling.REGISTRY.snapshot(reset=True)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return _run(tmp_path_factory, "single")


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    return _run(tmp_path_factory, "cards", runner="sharded", n_devices=4)


def _outputs(root):
    out = os.path.join(root, "outputs", PROJECT)
    h5, vid = {}, {}
    for f in sorted(os.listdir(os.path.join(out, "raw"))):
        if f.endswith(".h5"):
            with h5py.File(os.path.join(out, "raw", f), "r") as fh:
                h5[f] = {k: fh[k][()] for k in fh}
    for f in sorted(os.listdir(os.path.join(out, "vis"))):
        with open(os.path.join(out, "vis", f), "rb") as fh:
            vid[f] = fh.read()
    with open(os.path.join(out, "plots", "sim_results.json")) as fh:
        transfer = [e["run_summary"]["transfer"] for e in json.load(fh)]
    return h5, vid, transfer


def test_cards_write_what_one_device_writes(single, cards):
    h5_one, vid_one, tr_one = _outputs(single[0])
    h5_cards, vid_cards, tr_cards = _outputs(cards[0])
    assert sorted(h5_cards) == sorted(h5_one) and len(h5_one) == len(NUS)
    for f, ds in h5_one.items():
        assert sorted(h5_cards[f]) == sorted(ds)
        assert ds["turbulence"].shape[0] == 5  # steps 20 to 60
        for k, v in ds.items():
            np.testing.assert_array_equal(h5_cards[f][k], v, err_msg=f"{f} {k}")
    assert sorted(vid_cards) == sorted(vid_one) and len(vid_one) == len(NUS)
    for f, data in vid_one.items():
        assert data and vid_cards[f] == data, f
    assert tr_cards[0]["bytes_fetched"] == tr_one[0]["bytes_fetched"] > 0


def _in_loop(spans, name):
    return [s for s in spans if s.name == name and s.chunk is not None]


def test_no_field_crosses_between_cards_in_the_chunk_loop(cards):
    spans = cards[1]
    gathers = [s for s in spans if s.name == "engine.gather"]
    # the end-of-group inlet read gathers, after the loop
    assert gathers and all(s.attrs["bytes"] > 0 for s in gathers)
    assert _in_loop(spans, "engine.gather") == []
    assert _in_loop(spans, "loop.chunk")


def test_one_program_a_card_a_chunk(single, cards):
    spans = cards[1]
    chunks = {s.chunk for s in _in_loop(spans, "loop.chunk")}
    per = _in_loop(spans, "program.card")
    assert len(per) == 4 * len(chunks)
    for c in chunks:
        mine = [s for s in per if s.chunk == c]
        assert sorted(s.attrs["device"] for s in mine) == ["cpu"] * 4
        assert [s.attrs["cases"] for s in mine] == [2, 2, 2, 2]
    # one device: one program a chunk, and no gather anywhere
    one = single[1]
    assert len(_in_loop(one, "program.card")) == len({s.chunk for s in _in_loop(one, "loop.chunk")})
    assert [s for s in one if s.name == "engine.gather"] == []


def test_each_card_produces_its_saves(single, cards):
    for (root, spans), n_parts in ((cards, 4), (single, 1)):
        produce = _in_loop(spans, "loop.produce")
        by_chunk = {}
        for s in produce:
            by_chunk.setdefault((s.chunk, s.attrs["what"]), []).append(s)
        # from step 20 on: a dataset frame every chunk of 10 steps, a video
        # frame every 20 steps
        assert [w for _, w in by_chunk].count("moments") == 5
        assert [w for _, w in by_chunk].count("video") == 3
        for group in by_chunk.values():
            assert len(group) == n_parts
            assert all(s.attrs["device"] == "cpu" and s.attrs["bytes"] > 0 for s in group)
        # every byte handed to the stage was produced on its card
        fetched = _outputs(root)[2][0]["bytes_fetched"]
        assert sum(s.attrs["bytes"] for s in produce) == fetched


def test_five_cases_on_four_cards_use_three(capsys):
    from test_parallel import block_mask, grid_config

    cfgs = [grid_config(48, 24, rho_in=1.01 + 0.005 * i) for i in range(5)]
    eng = BatchEngine(cfgs, [block_mask(24, 48)] * 5, device="cpu", runner="sharded",
                      n_devices=4)
    assert [p.idx for p in eng.parts] == [[0, 1], [2, 3], [4]]
    out = capsys.readouterr().out
    assert "leave 1 of 4 devices without a case" in out
    full = BatchEngine(cfgs[:4], [block_mask(24, 48)] * 4, device="cpu", runner="sharded",
                       n_devices=4)
    assert [p.idx for p in full.parts] == [[0], [1], [2], [3]]
    assert "without a case" not in capsys.readouterr().out
