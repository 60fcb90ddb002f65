"""The lockstep loop's save stage (``pipeline/save_stage.py``) alone: its
worker's order and errors on the CPU, and on the card a copy that waits on
its producers and not on the work queued after it. The loop's own use of it
is held in ``test_torch_lockstep_options.py`` and ``test_torch_spans.py``.
No JAX here: the card's tests run with ``--noconftest -m cuda``."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.pipeline.save_stage import HELD, Save, SaveStage
from lbm2d_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


def test_worker_writes_in_hand_off_order_and_inline_on_the_callers_thread():
    for overlap in (True, False):
        seen = []

        def write(rows, failed):
            time.sleep(0.01)
            seen.append((threading.get_ident(), int(rows[0]), failed))

        with SaveStage(overlap=overlap) as stage:
            behind = []
            for k in range(4):
                behind.append(stage.hold([Save([torch.full((2,), float(k))], write)],
                                         frozenset({k})))
                stage.release()
        assert [(v, f) for _, v, f in seen] == [(k, frozenset({k})) for k in range(4)]
        threads = {t for t, _, _ in seen}
        assert len(threads) == 1
        assert (threading.get_ident() not in threads) == overlap
        assert behind[0] == 0 and (max(behind) > 0) == overlap
        assert stage.bytes_fetched == 4 * 2 * 4


def test_held_hand_off_reaches_the_worker_only_once_released():
    # the loop's use: hold a save behind its chunk, release it after the
    # next chunk's issue; the next hold and the stage's close release a
    # hand-off still held, in order, and the events of a coalesced hand-off
    # are written in their order
    seen, wrote = [], threading.Event()

    def write(rows, failed):
        seen.append(int(rows[0]))
        wrote.set()

    def save(k):
        return Save([torch.full((2,), float(k))], write)

    with SaveStage() as stage:
        assert stage.hold([save(0)], frozenset()) == 0
        time.sleep(0.05)
        assert seen == [] and stage.held == 0
        assert stage.release() == 0.0 and wrote.wait(10)
        assert stage.release() == 0.0  # nothing held
        stage.hold([save(1)], frozenset())
        stage.hold([save(2), save(3)], frozenset())
        stage.hold([save(4)], frozenset())
    assert seen == [0, 1, 2, 3, 4] and stage.held == 0


def test_hand_offs_under_stress_are_each_written_once_in_order():
    # 12 loops, each with its stage and worker (more threads than cores), the
    # interpreter switching threads as often as it can
    n_loops, n_saves = 12, 60
    written = {k: [] for k in range(n_loops)}
    errors = []

    def loop(k):
        try:
            def write(rows, failed):
                written[k].append(int(rows[0]))

            with SaveStage() as stage:
                for i in range(n_saves):
                    behind = stage.hold([Save([torch.full((4,), float(i))], write)], frozenset())
                    waited = stage.release()
                    assert behind <= HELD + 1 and (waited == 0.0 or behind >= HELD)
            assert stage.held == 0 and stage.bytes_fetched == n_saves * 16
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=loop, args=(k,)) for k in range(n_loops)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert all(w == list(range(n_saves)) for w in written.values())


def test_worker_error_is_raised_on_the_loops_next_call():
    def write(rows, failed):
        raise OSError("disk full")

    stage = SaveStage()
    stage.hold([Save([torch.zeros(3)], write)], frozenset())
    stage.release()
    with pytest.raises(RuntimeError, match="save worker failed") as err:
        stage.close()
    assert isinstance(err.value.__cause__, OSError)
    assert stage.held == 0


@pytest.mark.cuda
def test_copy_waits_on_its_producers_not_on_what_follows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.arange(5 * 9 * 256 * 512, dtype=torch.float32, device=dev).reshape(5, 9, 256, 512)
    want = (x * 1e-6).to(torch.float16).cpu().numpy()
    y_rgb = torch.randint(0, 256, (5, 970, 1024, 3), dtype=torch.uint8, device=dev)
    y_i420 = (torch.randint(0, 256, (5, 970, 1024), dtype=torch.uint8, device=dev),
              torch.randint(0, 256, (5, 485, 512, 2), dtype=torch.uint8, device=dev))
    want_rgb, want_i420 = y_rgb.cpu().numpy(), [t.cpu().numpy() for t in y_i420]
    torch.cuda.synchronize()
    after = torch.cuda.Event()
    recorded = threading.Event()
    seen = {}

    def writer(key):
        def write(rows, failed):
            # the copies are complete here; ``after`` follows the sleep
            # queued behind the hand-off
            assert recorded.wait(10)
            seen.setdefault("after_done", after.query())
            seen[key] = rows
        return write

    cycles = int(0.05 * torch.cuda.get_device_properties(dev).clock_rate * 1e3)  # ~50 ms
    profiling.REGISTRY.reset()
    with profiling.REGISTRY.recording(), SaveStage() as stage:
        y = (x * 1e-6).to(torch.float16)  # the producers, on the compute stream
        stage.hold([Save([y], writer("moments")), Save([y_rgb.clone()], writer("rgb")),
                    Save([tuple(t.clone() for t in y_i420)], writer("i420"))],
                   frozenset(), chunk=("g", 1))
        del y  # its block is not reused before the copy has read it
        stage.release()
        torch.cuda._sleep(cycles)  # what follows the hand-off
        after.record()
        recorded.set()
    d2h, = [s for s in profiling.REGISTRY.snapshot(reset=True) if s.name == "fetch.d2h"]
    assert seen["after_done"] is False
    # the span holds the copies' own time: 34.2 MB into pinned memory, well
    # under the sleep queued behind them
    nbytes = want.nbytes + want_rgb.nbytes + sum(a.nbytes for a in want_i420)
    assert d2h.chunk == ("g", 1) and d2h.attrs["bytes"] == nbytes
    assert 0 < d2h.seconds < 0.025, d2h
    assert seen["moments"].dtype == np.float16
    np.testing.assert_array_equal(seen["moments"], want)
    np.testing.assert_array_equal(seen["rgb"], want_rgb)
    assert isinstance(seen["i420"], tuple) and len(seen["i420"]) == 2
    for got, exp in zip(seen["i420"], want_i420):
        np.testing.assert_array_equal(got, exp)

