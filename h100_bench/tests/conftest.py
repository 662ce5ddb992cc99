"""The benchmark's own tests.  Tests that need the card carry the
`cuda` marker and decide in the `card` fixture, never at import, whether
there is one."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: Sizes a CPU test run holds; every other number is the cell's own.
TINY = {"cv6_mc.study": {"members": 512, "steps": 100},
        "cv6_imm.batch": {"targets": 16, "frames": 400}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


@pytest.fixture(scope="session")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())
