"""One torch thread budget for the port's test processes.

Every ``tests/test_torch_*.py`` imports this module (one line), which caps
torch's intra-op threads once a process at the process's share of the
cores: ``max(1, cpu_count // workers)``, ``workers`` being pytest-xdist's
``PYTEST_XDIST_WORKER_COUNT`` (1 without xdist). Without the cap every
xdist worker's torch opens as many threads as the host has cores, so six
workers on eight cores run 48 spinning threads on 8 cores and the port's
tests take ~7x their time. It also sets ``OMP_NUM_THREADS`` to the same
count, so the processes the multihost, multiworker and CLI tests spawn
use the same count, and reduce in the same order, as their parent.

Only the tests' processes are capped: the package itself never changes
torch's threading, and users' CPU runs keep torch's default.
"""

import os

import torch


def thread_share() -> int:
    """This process's share of the cores."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // workers)


N_THREADS = thread_share()
os.environ["OMP_NUM_THREADS"] = str(N_THREADS)
torch.set_num_threads(N_THREADS)
