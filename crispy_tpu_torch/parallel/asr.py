"""Tensor-parallel Whisper over a mesh: the counterpart of
``crispy_tpu/parallel/asr.py``.

Attention and MLP matrices split on the head/feature axis over ``"model"``:
q, k, v and fc1 column-parallel, out and fc2 row-parallel, their partial
sums added back into the replicated residual stream; the batch axis (30 s
chunks) splits over ``"data"``. Embeddings and norms replicate. The specs
are the JAX package's, as tuples (a ``PartitionSpec`` is a tuple).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import Mesh, data_sharding

Spec = Tuple


def whisper_param_spec(name: str, x, tp: int) -> Spec:
    """The partition of flat param ``name`` (the JAX package's [in, out]
    layout) over a model axis of size tp: ``(None, "model")`` column-parallel,
    ``("model",)`` its bias, ``("model", None)`` row-parallel, ``()``
    replicated. A width that tp does not divide replicates."""
    dim_out = np.shape(x)[-1] if np.ndim(x) else 0

    def ok(d):
        return d % max(tp, 1) == 0 and tp > 1

    if any(name.endswith(s) for s in (".q.w", ".k.w", ".v.w", ".fc1.w")) and ok(dim_out):
        return (None, "model")
    if any(name.endswith(s) for s in (".q.b", ".v.b", ".fc1.b")) and ok(np.shape(x)[0]):
        return ("model",)
    if any(name.endswith(s) for s in (".out.w", ".fc2.w")) and ok(np.shape(x)[0]):
        return ("model", None)
    return ()


def shard_whisper(model, mesh: Mesh):
    """Place a ``WhisperModel`` over the mesh (``WhisperModel.shard_to``)."""
    return model.shard_to(mesh)


def shard_batch(x: torch.Tensor, mesh: Mesh):
    """x's leading axis over ``"data"``, padded by repeating the last row."""
    return data_sharding(mesh, x, pad="edge")
