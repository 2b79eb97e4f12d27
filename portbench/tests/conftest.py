"""Fixtures of the benchmark's own tests: one torch thread (the tests run
beside others), and the card for the tests marked gpu."""

import pytest
import torch

import _portbench_common  # noqa: F401  (puts the repository on the path)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """The CUDA device, for the tests marked gpu; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
