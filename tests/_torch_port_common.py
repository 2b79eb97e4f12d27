"""Shared helpers of the tests/test_torch_*.py parity tests: the same
seeded numpy inputs go through a flax module of the JAX package and its
counterpart in the PyTorch port, with the flax weights carried across."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.utils.convert import state_dict_from_entries

# fp32 module parity: the same math with another summation order
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for a test module that imports this
    fixture, restored after it. The suite runs several test processes side
    by side, and torch's default of a thread a core oversubscribes the
    machine: small CPU ops then spend most of their time in the threads'
    spin-waits. Results compared within one process are unaffected; those
    compared with the JAX package keep their stated tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(params):
    """A flax variable tree with numpy leaves."""
    import jax

    return jax.tree.map(np.asarray, jax.device_get(params))


def load_port(module: torch.nn.Module, entries, tree, strip: str = ""):
    """Load the key-map `entries` read from flax `tree` into `module`,
    strictly, with `strip` removed from the front of every key."""
    sd = {k[len(strip):]: v for k, v in state_dict_from_entries(entries, tree).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def conv_entries(prefix: str, path: tuple):
    """Key map of one MaskedConv1D ({'conv': {'kernel', 'bias'}})."""
    return [(f"{prefix}conv.weight", path + ("conv", "kernel"),
             lambda w: np.transpose(w, (2, 1, 0))),
            (f"{prefix}conv.bias", path + ("conv", "bias"), lambda w: w)]


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def lengths_mask(b: int, length: int, lengths) -> np.ndarray:
    mask = np.zeros((b, length), bool)
    for i, ln in enumerate(lengths):
        mask[i, :ln] = True
    return mask


def close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)
