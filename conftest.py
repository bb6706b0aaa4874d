"""Each pytest-xdist worker runs torch on its share of the cores.

torch starts one intra-op thread a core in every process, so W workers on a
box of C cores would run W x C threads and the CPU tests would wait on each
other: each worker gets C // W (at least one).  Outside xdist (one process)
torch keeps its default.
"""

import os


def pytest_configure(config):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
