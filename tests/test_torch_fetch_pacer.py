"""The port's FetchPacer and D2H probe (pipeline/fetch_pacer.py) against
the JAX package's, and grouped fetches in the port's lockstep loop.

The controller is plain Python in both packages: fed the same stall
sequence, the two must choose the same fetch group sizes chunk by chunk.
"""

import os

import h5py
import numpy as np
import pytest

from lbm2d_tpu.pipeline.fetch_pacer import FetchPacer as JaxFetchPacer
from lbm2d_tpu_torch.pipeline.fetch_pacer import FetchPacer, probe_d2h_mbps
from test_fetch_pacer import FakeLink
from tests.test_multiworker import make_four_case_project


def _stall_sequences():
    rng = np.random.default_rng(0)
    return {
        "slow-link": [(0.10, 0.25)] * 40 + [(0.10, 0.0)] * 60,
        "healthy": [(0.10, 0.002)] * 50,
        "borderline": [(0.10, float(s)) for s in rng.uniform(0.0, 0.05, 80)],
        "bursty": [(float(c), float(s)) for c, s in
                   zip(rng.uniform(0.05, 0.2, 120), rng.exponential(0.05, 120))],
    }


@pytest.mark.parametrize("name", sorted(_stall_sequences()))
@pytest.mark.parametrize("window, max_group", [(8, 8), (4, 2)], ids=["default", "small"])
def test_same_stalls_give_the_jax_group_sizes(name, window, max_group):
    ref = JaxFetchPacer(max_group=max_group, window=window)
    pacer = FetchPacer(max_group=max_group, window=window)
    for compute_s, stall_s in _stall_sequences()[name]:
        ref.record_chunk(compute_s, stall_s)
        pacer.record_chunk(compute_s, stall_s)
        assert pacer.group_size == ref.group_size
        assert pacer.should_fetch(3) == ref.should_fetch(3)
    assert pacer.stats() == ref.stats()


def test_fake_link_run_matches_jax():
    def link():
        return FakeLink(fixed_s=0.15, per_frame_s=0.02, chunk_s=0.10)

    util_ref, n_ref = link().run(JaxFetchPacer())
    pacer = FetchPacer()
    util, n = link().run(pacer)
    assert (util, n) == (util_ref, n_ref)
    assert pacer.group_size > 1 and util >= 0.75


def test_bad_thresholds_raise():
    with pytest.raises(ValueError):
        FetchPacer(stall_hi=0.1, stall_lo=0.2)


def test_cpu_probe_measures_a_host_copy():
    assert probe_d2h_mbps(nbytes=1 << 20, device="cpu") > 0


def _run_group(root, pacer):
    from lbm2d_tpu_torch.pipeline import paths
    from lbm2d_tpu_torch.pipeline.batch_datagen import run_lockstep_group
    from lbm2d_tpu_torch.utils.config import load_config

    names = make_four_case_project(root, name="FP")
    project_paths = paths.get_project_paths("FP", root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])
    members = [
        (n, load_config(os.path.join(project_paths["configs"], n))) for n in names[:2]
    ]
    entries = run_lockstep_group(
        members, project_paths, output_dirs, progress=False, video=False,
        pacer=pacer, device="cpu",
    )
    return entries, output_dirs


def test_grouped_fetch_byte_parity(tmp_path):
    frozen = FetchPacer(stall_hi=0.99, stall_lo=0.0)  # never adapts...
    frozen.group_size = 4  # ...but batches every 4 save events
    runs = {}
    for tag, pacer in (("plain", None), ("grouped", frozen)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        entries, output_dirs = _run_group(root, pacer)
        assert all(e["status"] == "Success" for e in entries), entries
        runs[tag] = (entries, output_dirs)
    for entry in runs["plain"][0]:
        data = {}
        for tag, (_e, dirs) in runs.items():
            with h5py.File(os.path.join(dirs["raw"], entry["case_name"] + ".h5")) as f:
                data[tag] = {k: f[k][...].tobytes() for k in f.keys()}
        assert data["plain"] == data["grouped"], entry["case_name"]
    for tag, (entries, _d) in runs.items():
        tr = entries[0]["run_summary"]["transfer"]
        assert tr["link_d2h_mbps_pre"] > 0 and tr["link_d2h_mbps_post"] > 0
        assert tr["bytes_fetched"] > 0
    assert runs["grouped"][0][0]["run_summary"]["transfer"]["fetch_group_size_final"] == 4


def test_stall_calibration_from_chunks_without_a_fetch():
    # a host-paced loop (the H100's): monitor waits far below the 50 ms
    # gate. Chunks with no fetch in flight calibrate the chunk-wall
    # estimate, so a fetch whose join wait the chunk hid charges no stall
    pacer = FetchPacer(window=4)
    assert pacer.record_wall(0.020, 0.001, 0.0, fetching=False) == 0.0
    assert pacer.chunk_wall_est == 0.020 and pacer.calibrating_chunks == 1
    assert pacer.record_wall(0.020, 0.001, 0.015) == 0.0
    assert pacer.record_wall(0.028, 0.001, 0.015) == pytest.approx(0.008)
    assert pacer.calibrating_chunks == 1
    # a device-bound chunk still calibrates, fetch or not
    assert pacer.record_wall(0.030, 0.060, 0.015) == 0.0
    assert pacer.chunk_wall_est == pytest.approx(0.7 * 0.020 + 0.3 * 0.030)
    # the reference's rule alone (a fetch joined every chunk, host-paced)
    # never forms an estimate: the raw join wait counts as stall and the
    # group grows although the chunk hid the transfer
    ref = FetchPacer()
    for _ in range(16):
        assert ref.record_wall(0.020, 0.001, 0.015) == 0.015
    assert ref.chunk_wall_est is None and ref.group_size > 1
