"""pytest setup for the PyTorch port's tests.

Registers the `cuda` marker and the `cuda_device` fixture: a test that needs
the card takes the fixture, which skips it (with a reason) when no CUDA
device is present.  The decision is made when the test runs, never while a
module is imported, so every worker collects the same tests.  Keeps JAX,
the reference, on the CPU.
"""
import os

import pytest

# JAX is the CPU reference of these tests.  On a machine with a card (whose
# environment may name it among JAX's platforms), a test module that imports
# JAX would otherwise have it take 75 % of the card's memory at its first
# array, beside the port's tests that run there.
os.environ["JAX_PLATFORMS"] = "cpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the port's CUDA kernels)")


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    """Small CPU tensors: one intra-op thread per test process is faster than
    many, and does not oversubscribe the cores that parallel test workers
    share."""
    torch = pytest.importorskip("torch")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")
