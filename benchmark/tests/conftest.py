"""The benchmark's CPU tests: the benchmark's folder and the checkout's
root on sys.path, as `benchmark/run.py` puts them, and one intra-op
thread (the tiny runs compare the port with the reference on the CPU)."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH / "tests"), str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny

    return tiny.write_root(tmp_path_factory.mktemp("bench_root"))
