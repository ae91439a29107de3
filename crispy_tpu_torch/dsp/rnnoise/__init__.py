"""RNNoise noise suppression in PyTorch with CUDA kernels.

  constants     — frame geometry and constant tables (NumPy)
  weights       — model container, npz format, builtin model
  pipeline      — batched frame-parallel block pipeline (PyTorch)
  graphed       — the block step replayed from a CUDA graph (live monitoring)
  rnn_kernels   — the GRU network scan (K1) and the remove_doubling
                  continuation scan (K2), each with its plain version
  ops_kernels   — the pitch-window gather (K3) and the remove_doubling
                  candidate gather
  oracle        — the NumPy oracle of the frame chain (a copy of the JAX
                  package's)
"""

from .constants import FRAME_SIZE, NB_BANDS, NB_FEATURES  # noqa: F401
from .weights import RNNoiseModel, builtin_model, deterministic_test_model  # noqa: F401
