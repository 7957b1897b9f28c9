"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repo (CPU; the tests marked ``cuda`` skip without a card
and run on one as ``python -m pytest benchmark/tests -q -m cuda``)."""

import os
import sys
from pathlib import Path

os.environ.setdefault("OMP_NUM_THREADS", "1")

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
