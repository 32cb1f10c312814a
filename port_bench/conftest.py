"""pytest setup for the benchmark's own tests.

Puts the benchmark's packages (`pbench`, `reference`) and the program
(`src/`) on the path, and registers the `cuda` marker with its
`cuda_device` fixture: a test that needs the card takes the fixture, which
skips it (with a reason) when no CUDA device is present.  The decision is
made when the test runs, never while a module is imported."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the port's CUDA kernels)")


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")
