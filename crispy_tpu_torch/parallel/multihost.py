"""Several processes over ``torch.distributed``: the port of
``crispy_tpu/parallel/multihost.py``.

The JAX package joins every host's devices into one global mesh
(``jax.distributed``), feeds each host's rows into a globally sharded array
and lets XLA route the collectives. PyTorch runs one program per process:
here each process holds a ``ProcessMesh``, its own devices as a port
``Mesh`` (``local``) plus its place among the processes, and works on its
own rows. Inference needs no collective: a process runs its rows over
``mesh.local`` through ``denoise_batch(mesh=...)`` and the Whisper paths.
The training step (``parallel/train.make_train_step(mesh=...)``) adds the
two collectives DP needs: the loss's global denominators and the gradient
sum.

``launch_local`` starts the ranks of one job on this host (the tests'
drill on the CPU, ``chip_smoke.py`` [17c] on one card); each rank calls
``initialize_from_env`` and reads its place from the environment.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import Mesh, visible_devices

DEFAULT_TIMEOUT = 300.0  # seconds a rank waits for the others (rendezvous, collectives)

# This process's devices, set by initialize_from_env (the counterpart of the
# process-wide device set jax.distributed.initialize fixes).
_local_devices: Optional[List[torch.device]] = None


def _init_url(address: str) -> str:
    """``host:port`` (the JAX package's form) as a TCP rendezvous URL;
    a URL (``tcp://``, ``file://``) passes unchanged."""
    return address if "://" in address else f"tcp://{address}"


def _card_ids(devices: Sequence[torch.device]) -> List[str]:
    return [str(torch.cuda.get_device_properties(d).uuid) for d in devices]


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> str:
    """``torch.distributed.init_process_group`` for one crispy process.

    Arguments default from ``CRISPY_COORDINATOR`` (``host:port``, or a
    ``tcp://`` or ``file://`` URL) / ``CRISPY_NUM_PROCESSES`` /
    ``CRISPY_PROCESS_ID``. Every wait (the rendezvous, each collective)
    gives up after ``timeout`` seconds.

    ``platform="cpu"`` is the hardware-free path: gloo, and
    ``local_device_count`` (default 1) entries of ``"cpu"`` as this
    process's devices. Otherwise the process's devices are the visible cards
    (the first ``local_device_count`` of them, if given), and it raises
    without one. The backend is then chosen from the cards the ranks name
    in the rendezvous: ``nccl`` when every rank has cards of its own,
    ``gloo`` when two ranks share a card (NCCL refuses two ranks on one
    GPU; gloo reduces CUDA tensors through the host). Returns the backend.
    """
    global _local_devices
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("CRISPY_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CRISPY_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("CRISPY_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multihost init needs coordinator_address + num_processes + "
            "process_id (args or CRISPY_COORDINATOR / CRISPY_NUM_PROCESSES "
            "/ CRISPY_PROCESS_ID)")

    if platform == "cpu":
        devices = [torch.device("cpu")] * int(local_device_count or 1)
    else:
        devices = visible_devices()
        if local_device_count:
            devices = devices[:int(local_device_count)]
    wait = datetime.timedelta(seconds=timeout)
    store, rank, world = next(dist.rendezvous(
        _init_url(coordinator_address), process_id, num_processes, timeout=wait))
    if platform == "cpu":
        backend = "gloo"
    else:
        store.set(f"crispy/cards/{rank}", ",".join(_card_ids(devices)))
        cards = [c for r in range(world)
                 for c in store.get(f"crispy/cards/{r}").decode().split(",")]
        backend = "nccl" if len(set(cards)) == len(cards) else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=wait)
    _local_devices = devices
    return backend


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a job: its own devices as a port ``Mesh``
    (``local``), its index among ``process_count`` processes, and every
    process's device count and data rows (``sizes``, ``dps``, in process
    order). A plain ``Mesh`` is ``ProcessMesh.single(mesh)``."""

    local: Mesh
    process_index: int
    process_count: int
    sizes: Tuple[int, ...]
    dps: Tuple[int, ...]

    @staticmethod
    def single(mesh: Mesh) -> "ProcessMesh":
        return ProcessMesh(mesh, 0, 1, (mesh.dp * mesh.tp,), (mesh.dp,))

    @property
    def devices(self) -> np.ndarray:
        """Every device of the job as (process, local index), in process
        order: ``devices.size`` is the job's device count."""
        out = np.empty(sum(self.sizes), dtype=object)
        out[:] = [(p, j) for p, n in enumerate(self.sizes) for j in range(n)]
        return out

    @property
    def global_dp(self) -> int:
        """Data rows over all processes."""
        return sum(self.dps)

    @property
    def row_offset(self) -> int:
        """The index of this process's first data row among all of them."""
        return sum(self.dps[:self.process_index])


def as_process_mesh(mesh) -> ProcessMesh:
    """A ``ProcessMesh`` as is; a ``Mesh`` as the one process of its job."""
    return mesh if isinstance(mesh, ProcessMesh) else ProcessMesh.single(mesh)


def global_data_mesh(axes: Tuple[str, ...] = ("data",)) -> ProcessMesh:
    """This process's devices on one data axis (dp = their count, tp = 1)
    and its place in the job. The job's device counts come from one
    all-gather (staged on the host under gloo). Without an initialized
    process group, the one process of its job over the visible cards."""
    import torch.distributed as dist

    if not dist.is_initialized():
        devices = visible_devices()
        return ProcessMesh.single(Mesh(tuple((d,) for d in devices), (axes[0], "model")))
    devices = _local_devices if _local_devices is not None else visible_devices()
    local = Mesh(tuple((d,) for d in devices), (axes[0], "model"))
    stage = devices[0] if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([len(devices), local.dp], dtype=torch.int64, device=stage)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    counts = [tuple(int(x) for x in t.cpu()) for t in every]
    return ProcessMesh(local, dist.get_rank(), dist.get_world_size(),
                       tuple(c[0] for c in counts), tuple(c[1] for c in counts))


@dataclass(frozen=True)
class ProcessLocal:
    """This process's rows of a global array: ``parts`` split over the
    local data rows (part i on ``mesh.local``'s row i), with the global
    shape and this process's first index along ``axis``."""

    parts: Tuple[torch.Tensor, ...]
    global_shape: Tuple[int, ...]
    offset: int
    axis: int


def feed_process_local(mesh: ProcessMesh, local_batch, axis: int = 0) -> ProcessLocal:
    """Host-local rows -> this process's part of a global array, split
    evenly over the local data rows (each part on its row's first device).

    The global shape is the local one times the process count along
    ``axis``, and this process's offset its index times its rows, as
    ``jax.make_array_from_process_local_data`` assumes. No data crosses
    processes."""
    mesh = as_process_mesh(mesh)
    a = np.asarray(local_batch)
    devs = mesh.local.data_devices()
    if a.shape[axis] % len(devs):
        raise ValueError(f"{a.shape[axis]} rows along axis {axis} do not split evenly over "
                         f"{len(devs)} local data rows")
    parts = tuple(torch.from_numpy(np.ascontiguousarray(p)).to(d)
                  for p, d in zip(np.split(a, len(devs), axis=axis), devs))
    shape = list(a.shape)
    shape[axis] *= mesh.process_count
    return ProcessLocal(parts, tuple(shape), mesh.process_index * a.shape[axis], axis)


def feed_process_local_tree(mesh: ProcessMesh, tree, axis: int = 0):
    """``feed_process_local`` over every array of a (nested) dict, e.g. the
    denoiser's per-stream state."""
    if isinstance(tree, dict):
        return {k: feed_process_local_tree(mesh, v, axis) for k, v in tree.items()}
    return feed_process_local(mesh, tree, axis)


def gather_local(arr, axis: int = 0) -> np.ndarray:
    """This process's rows as NumPy, in global order along ``axis``: the
    parts of a ``ProcessLocal``, or a sequence of per-row outputs computed
    from them, concatenated on the host."""
    parts = arr.parts if isinstance(arr, ProcessLocal) else arr
    return np.concatenate([torch.as_tensor(p).detach().cpu().numpy() for p in parts],
                          axis=axis)


def launch_local(argv: Sequence[str], num_processes: int, coordinator: str,
                 timeout: float, log_dir, env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``argv`` as ranks 0..num_processes-1 of one job on this host,
    each with ``CRISPY_COORDINATOR``/``CRISPY_NUM_PROCESSES``/
    ``CRISPY_PROCESS_ID`` in its environment and its output in
    ``log_dir/rank<i>.log``. When a rank fails, or ``timeout`` seconds
    pass, every other rank is killed and RuntimeError says which rank and
    why. Returns each rank's output."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    try:
        for r in range(num_processes):
            e = dict(base, CRISPY_COORDINATOR=coordinator,
                     CRISPY_NUM_PROCESSES=str(num_processes), CRISPY_PROCESS_ID=str(r))
            logs.append(open(log_dir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(list(argv), env=e, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
        for f in logs:
            f.close()
    outs = [(log_dir / f"rank{r}.log").read_text() for r in range(num_processes)]
    if failed == "timeout":
        raise RuntimeError(f"the ranks did not finish in {timeout:.0f} s; rank 0 said:\n"
                           f"{outs[0][-4000:]}")
    if failed is not None:
        raise RuntimeError(f"rank {failed} exited with {procs[failed].returncode}:\n"
                           f"{outs[failed][-4000:]}")
    return outs


__all__ = ["ProcessLocal", "ProcessMesh", "as_process_mesh", "feed_process_local",
           "feed_process_local_tree", "gather_local", "global_data_mesh",
           "initialize_from_env", "launch_local"]
