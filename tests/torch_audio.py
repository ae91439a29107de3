"""Speech-like test audio shared by the port's tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


def speechlike(n, seed=0, f0=110.0, sr=48000, level=0.4):
    """Harmonic tone with a slow amplitude wobble plus a little noise,
    made from ``seed``; float32 in [-level, level]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    sig = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * t + 0.13 * k) for k in range(1, 9))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t + seed))
    sig += 0.03 * rng.standard_normal(n)
    return (level * sig / np.max(np.abs(sig))).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests: their many small ops,
    with several test workers on the machine, oversubscribe the cores
    through torch's thread pool (a decode test then took minutes, not
    seconds). Test modules take it with ``from torch_audio import
    one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
