"""One process over a list of devices: the port's mesh and its placement
helpers, the counterpart of ``crispy_tpu/parallel/__init__.py``.

The JAX package runs SPMD over a ``jax.sharding.Mesh``: batch and stream
axes shard over ``"data"`` (DP), wide model dimensions over ``"model"``
(TP), and XLA inserts the collectives. Here a ``Mesh`` is a 2-D grid of
explicit torch devices with the same axes (``devices.shape`` is (dp, tp)),
and the entry points that take ``mesh=`` place the work themselves: data
row i of the grid runs shard i of a batch on ``devices[i, 0]``, its model
pieces on ``devices[i, :]``, and the results come back gathered in stream
order. A device may repeat (``["cuda:0"] * 2`` on one card runs the split
code); repeated entries share one copy of every replicated tensor.

``parallel/train.py`` holds the training net and its step, DP x TP over a
mesh; ``parallel/multihost.py`` adds several processes over
``torch.distributed`` (a ``ProcessMesh``: this process's devices as a
``Mesh`` and its place in the job).
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of explicit torch devices. Hashable: caches key
    by mesh, as the JAX package's do."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    axes: Tuple[str, str] = ("data", "model")

    def __post_init__(self):
        rows = tuple(tuple(_explicit(d) for d in row) for row in self.grid)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        object.__setattr__(self, "grid", rows)
        object.__setattr__(self, "axes", tuple(self.axes))

    @property
    def devices(self) -> np.ndarray:
        """The grid as a [dp, tp] object array (the JAX meaning)."""
        out = np.empty((len(self.grid), len(self.grid[0])), dtype=object)
        for i, row in enumerate(self.grid):
            for j, d in enumerate(row):
                out[i, j] = d
        return out

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def tp(self) -> int:
        return len(self.grid[0])

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]

    def data_devices(self) -> List[torch.device]:
        """The device each data row runs on (its first)."""
        return [row[0] for row in self.grid]

    def flat(self) -> List[torch.device]:
        return [d for row in self.grid for d in row]

    def distinct(self) -> List[torch.device]:
        """Every device of the grid once, in grid order."""
        return list(dict.fromkeys(self.flat()))


def _explicit(device) -> torch.device:
    """A torch device with its index: ``cuda`` alone names no card."""
    d = torch.device(device)
    if d.type == "cuda":
        if d.index is None:
            raise ValueError("a mesh names CUDA devices by index (cuda:0), not 'cuda'")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a mesh over the card")
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(f"{d} is not present ({torch.cuda.device_count()} visible)")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def visible_devices() -> List[torch.device]:
    """``cuda:0 .. cuda:n-1``; raises with no card, as
    ``device.resolve_device`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...] "
                           "for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axes: Tuple[str, str] = ("data", "model"),
              model_parallel: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible card).

    model_parallel defaults to 2 when the device count is even and at least
    2, else 1 (the JAX package's rule)."""
    devs = list(visible_devices() if devices is None else devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // model_parallel
    if dp == 0:
        raise ValueError(f"model_parallel={model_parallel} exceeds {n} devices")
    grid = tuple(tuple(devs[i * model_parallel:(i + 1) * model_parallel]) for i in range(dp))
    return Mesh(grid, tuple(axes))


def check_device(mesh: Optional[Mesh], device) -> None:
    """``device`` beside ``mesh=`` must be None or the mesh's first device
    (a bare ``cuda`` means the current card)."""
    if mesh is None or device is None:
        return
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    if d != mesh.first:
        raise ValueError(f"device={device} conflicts with the mesh, whose first device "
                         f"is {mesh.first}")


# ---------------------------------------------------------------------------
# Placement helpers (the JAX package's sharding helpers)
# ---------------------------------------------------------------------------

def pad_rows(x: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """x with its leading axis padded to n rows: ``"zeros"`` appends zero
    rows, ``"edge"`` repeats the last row."""
    extra = n - x.shape[0]
    if extra <= 0:
        return x
    if mode == "zeros":
        tail = x.new_zeros((extra,) + tuple(x.shape[1:]))
    elif mode == "edge":
        tail = x[-1:].expand((extra,) + tuple(x.shape[1:]))
    else:
        raise ValueError(f"unknown padding {mode!r}")
    return torch.cat([x, tail])


def data_sharding(mesh: Mesh, x: torch.Tensor, pad: str = "edge") -> List[torch.Tensor]:
    """Split x's leading axis over the data rows: padded (``pad_rows``) to a
    multiple of dp, one equal piece per row on the row's device."""
    dp = mesh.dp
    x = pad_rows(x, -(-x.shape[0] // dp) * dp, pad)
    return [p.to(d) for p, d in zip(x.chunk(dp), mesh.data_devices())]


def replicated(mesh: Mesh, x: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
    """One copy of x on each distinct device (no copy where x already is)."""
    return {d: x.to(d) for d in mesh.distinct()}


def model_sharding(mesh: Mesh, x: torch.Tensor, axis: int = -1,
                   row: int = 0) -> List[torch.Tensor]:
    """Split ``axis`` of x over the model axis: piece j on data row
    ``row``'s j-th device. A piece on x's own device is a view of x."""
    devs = mesh.grid[row]
    return [p.to(d) for p, d in zip(x.chunk(len(devs), dim=axis), devs)]


_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def module_on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """module itself on the device its weights lie on, else one copy of it
    there, made at the first call and kept while the module lives."""
    if next(module.parameters()).device == device:
        return module
    copies = _COPIES.setdefault(module, {})
    if device not in copies:
        with torch.no_grad():
            copies[device] = copy.deepcopy(module).to(device)
    return copies[device]


def gather(parts: Sequence[torch.Tensor], device: torch.device,
           n: Optional[int] = None) -> torch.Tensor:
    """Shards back on one device in stream order, cut to the first n rows."""
    out = torch.cat([p.to(device) for p in parts])
    return out if n is None else out[:n]


__all__ = ["Mesh", "check_device", "data_sharding", "gather", "make_mesh",
           "model_sharding", "module_on", "pad_rows", "replicated", "visible_devices"]
