"""Several processes in the port (crispy_tpu_torch.parallel.multihost) held
against the JAX package on the CPU: the mirror of tests/test_multihost.py.

``initialize_from_env`` resolves its arguments and environment as the JAX
package's does. The drill starts real processes through
``multihost.launch_local`` (gloo on the CPU, a ``file://`` rendezvous in the
test's directory: no port to lose to another test worker), 2 processes x 2
devices and 3 processes x 1 device. Each rank runs this file's
``rank_main``: it feeds its rows of a global batch, runs one denoise block
over its fed shards and ``denoise_batch(mesh=mesh.local)``, a Whisper
greedy decode of 3 tokens over ``mesh.local``, and 3 DP training steps over
the process mesh, and writes what it got. The parent holds every rank's
rows to the JAX package's unsharded block and decode, and the training
losses and parameters to the JAX step over a mesh of the job's size.

The rank entry imports neither JAX nor the JAX package (the scan in
tests/test_torch_parallel.py reads everything here but the ``test_`` and
``jax_`` functions, which only the parent runs).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
STREAMS_PER_PROC = 4  # denoise streams a process feeds
FRAMES = 4  # one block of 4 frames
ASR_PER_PROC = 2  # whisper chunks a process feeds
ASR_NEW = 3
TRAIN_B = 12  # the training batch splits over 4 and over 3 data rows
TRAIN_F = 10
TRAIN_STEPS = 3
RANK_TIMEOUT = 300  # seconds for a whole drill; each rank's collectives give up after 120
# The rows against the JAX package's unsharded block: the f32 pipelines'
# difference on speech-like audio (tests/test_torch_rnnoise_pipeline.py).
JAX_ATOL = 5e-5


# ---------------------------------------------------------------------------
# The job's inputs: the same in every rank and in the parent
# ---------------------------------------------------------------------------

def drill_audio(nproc):
    """[S, FRAMES * 480] speech-like streams, STREAMS_PER_PROC a process."""
    return np.stack([speechlike(FRAMES * 480, seed=s, f0=90.0 + 13.0 * s)
                     for s in range(STREAMS_PER_PROC * nproc)])


def drill_mel(nproc, n_mels):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((ASR_PER_PROC * nproc, n_mels, 3000)) * 0.5).astype(np.float32)


def drill_params():
    """train_model's init draw (0.08 N(0, 1)), biases included."""
    from crispy_tpu_torch.parallel import train as pt

    rng = np.random.default_rng(2)
    return {k: (rng.standard_normal(v.shape) * 0.08).astype(np.float32)
            for k, v in pt.init_train_params().items()}


def drill_batch(step):
    """The global batch of a step, silence frames masked."""
    from crispy_tpu_torch.parallel import train as pt

    batch = pt.synthetic_batch(TRAIN_B, TRAIN_F, seed=10 + step)
    rng = np.random.default_rng(20 + step)
    batch["mask"] = (rng.uniform(0, 1, (TRAIN_B, TRAIN_F)) > 0.3).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# One rank (run as ``python tests/test_torch_multihost.py LOCAL_DEVICES OUTDIR``)
# ---------------------------------------------------------------------------

def rank_main(local_devices: int, outdir: Path) -> None:
    from crispy_tpu_torch.dsp.rnnoise import pipeline
    from crispy_tpu_torch.dsp.rnnoise.weights import deterministic_test_model
    from crispy_tpu_torch.models.whisper import WhisperModel
    from crispy_tpu_torch.models.whisper.model import greedy_decode
    from crispy_tpu_torch.parallel import multihost as mh
    from crispy_tpu_torch.parallel import train as pt

    torch.set_num_threads(1)
    backend = mh.initialize_from_env(platform="cpu", local_device_count=local_devices,
                                     timeout=120)
    mesh = mh.global_data_mesh()
    pid, nproc = mesh.process_index, mesh.process_count
    if mesh.local.devices.shape != (local_devices, 1) or mesh.devices.size != nproc * local_devices:
        raise RuntimeError(f"mesh {mesh}")
    out = {"backend": np.array(backend), "devices": np.array(mesh.devices.size)}

    # denoise: the block step over the fed shards, and denoise_batch over mesh.local
    full = drill_audio(nproc)
    lo, hi = pid * STREAMS_PER_PROC, (pid + 1) * STREAMS_PER_PROC
    model = deterministic_test_model()
    params = pipeline.make_params(model, "cpu")
    state0 = {k: v.numpy() for k, v in pipeline.init_state(full.shape[0], "cpu").items()}
    state = mh.feed_process_local_tree(mesh, {k: v[lo:hi] for k, v in state0.items()})
    block = mh.feed_process_local(mesh, full[lo:hi])
    if block.offset != lo or block.global_shape != full.shape:
        raise RuntimeError(f"fed {block.offset} {block.global_shape}")
    with torch.no_grad():
        outs = [pipeline.denoise_block(params, {k: v.parts[i] for k, v in state.items()},
                                       block.parts[i])[1]
                for i in range(mesh.local.dp)]
    out["block"] = mh.gather_local(outs)
    out["batch"] = pipeline.denoise_batch(full[lo:hi], model, block_frames=FRAMES,
                                          mesh=mesh.local)

    # whisper greedy decode over mesh.local, one replica per local data row
    wm = WhisperModel.random("test-random", seed=0, device="cpu").shard_to(mesh.local)
    a_lo = pid * ASR_PER_PROC
    mel = mh.feed_process_local(mesh, drill_mel(nproc, wm.cfg.n_mels)[a_lo:a_lo + ASR_PER_PROC])
    prompt = mh.feed_process_local(mesh, np.full((ASR_PER_PROC, 1), wm.cfg.sot, np.int64))
    out["tokens"] = mh.gather_local([greedy_decode(rep, m, p, max_new=ASR_NEW, eot=wm.cfg.eot)[0]
                                     for rep, m, p in zip(wm.replicas, mel.parts, prompt.parts)])

    # DP training over the process mesh
    step, to_params, to_batch, optimizer = pt.make_train_step(mesh=mesh)
    net = to_params(drill_params())
    opt = optimizer(net)
    losses = []
    for s in range(TRAIN_STEPS):
        net, opt, loss = step(net, opt, to_batch(drill_batch(s)))
        losses.append(float(loss))
    got = net.params_to_numpy()
    for rep in net.replicas[1:]:
        other = rep.params_to_numpy()
        if not all(np.array_equal(other[k], got[k]) for k in got):
            raise RuntimeError("the replicas differ")
    out["losses"] = np.array(losses)
    out.update({f"param:{k}": v for k, v in got.items()})
    np.savez(outdir / f"rank{pid}.npz", **out)
    torch.distributed.destroy_process_group()
    print(f"[rank {pid}] DRILL_OK backend={backend}", flush=True)


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------

def test_initialize_from_env_resolves_args_and_environment(monkeypatch):
    import torch.distributed as dist

    from crispy_tpu_torch.parallel import multihost as mh

    for k in ("CRISPY_COORDINATOR", "CRISPY_NUM_PROCESSES", "CRISPY_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    msg = "coordinator_address \\+ num_processes \\+ process_id"
    with pytest.raises(ValueError, match=msg):
        mh.initialize_from_env()
    with pytest.raises(ValueError, match=msg):
        mh.initialize_from_env("127.0.0.1:1", num_processes=2)  # no process id
    monkeypatch.setenv("CRISPY_PROCESS_ID", "0")
    with pytest.raises(ValueError, match=msg):
        mh.initialize_from_env("127.0.0.1:1")  # no process count

    seen = {}

    def rendezvous(url, rank, world, timeout):
        seen.update(url=url, rank=rank, world=world, timeout=timeout.total_seconds())
        yield object(), rank, world

    def init(backend, store, rank, world_size, timeout):
        seen.update(backend=backend)

    monkeypatch.setattr(dist, "rendezvous", rendezvous)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(mh, "_local_devices", None)
    monkeypatch.setenv("CRISPY_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("CRISPY_NUM_PROCESSES", "3")
    monkeypatch.setenv("CRISPY_PROCESS_ID", "2")
    assert mh.initialize_from_env(platform="cpu", local_device_count=2, timeout=7) == "gloo"
    assert seen == dict(url="tcp://10.0.0.1:1234", rank=2, world=3, timeout=7.0, backend="gloo")
    assert mh._local_devices == [torch.device("cpu")] * 2
    # arguments win over the environment; a URL passes unchanged
    assert mh.initialize_from_env("file:///tmp/x", 4, 1, platform="cpu") == "gloo"
    assert (seen["url"], seen["rank"], seen["world"]) == ("file:///tmp/x", 1, 4)
    assert mh._local_devices == [torch.device("cpu")]
    if not torch.cuda.is_available():  # no CPU fallback without platform="cpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.initialize_from_env()
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.global_data_mesh()


def test_process_local_feeding_without_a_process_group():
    from crispy_tpu_torch import parallel
    from crispy_tpu_torch.parallel import multihost as mh

    pm = mh.ProcessMesh(parallel.make_mesh(devices=["cpu"] * 2, model_parallel=1),
                        process_index=1, process_count=3, sizes=(2, 2, 2), dps=(2, 2, 2))
    assert pm.devices.size == 6 and pm.global_dp == 6 and pm.row_offset == 2
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    fed = mh.feed_process_local(pm, x)
    assert fed.global_shape == (12, 6) and fed.offset == 4 and len(fed.parts) == 2
    assert [p.shape for p in fed.parts] == [(2, 6), (2, 6)]
    assert np.array_equal(mh.gather_local(fed), x)
    col = mh.feed_process_local(pm, x, axis=1)
    assert col.global_shape == (4, 18) and col.offset == 6
    assert np.array_equal(mh.gather_local(col, axis=1), x)
    tree = mh.feed_process_local_tree(pm, {"a": x, "b": {"c": x[:, :2]}})
    assert np.array_equal(mh.gather_local(tree["b"]["c"]), x[:, :2])
    with pytest.raises(ValueError, match="split evenly"):
        mh.feed_process_local(pm, x[:3])
    single = mh.as_process_mesh(parallel.make_mesh(devices=["cpu"] * 4))
    assert (single.process_count, single.global_dp, single.devices.size) == (1, 2, 4)


def jax_references(nproc, local):
    """The JAX package's unsharded denoise block and greedy decode of the
    whole job's rows, and its training step over a mesh of the job's size:
    (block out, tokens, losses, params, grads a step)."""
    import jax.numpy as jnp

    from crispy_tpu import parallel as jparallel
    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
    from crispy_tpu.models.whisper import WhisperModel
    from crispy_tpu.models.whisper.model import greedy_decode
    from test_torch_train_step import jax_mesh_run

    full = drill_audio(nproc)
    _, block, _ = jp._denoise_block_jit(jp.make_params(deterministic_test_model()),
                                   jp.init_state(full.shape[0]), jnp.asarray(full))
    wm = WhisperModel.random("test-random", seed=0)
    mel = drill_mel(nproc, wm.cfg.n_mels)
    toks, _ = greedy_decode(wm.params, wm.cfg, jnp.asarray(mel),
                            jnp.full((mel.shape[0], 1), wm.cfg.sot, jnp.int32),
                            max_new=ASR_NEW, eot=wm.cfg.eot)
    run = jax_mesh_run(jparallel.make_mesh(nproc * local), drill_params(),
                       [drill_batch(s) for s in range(TRAIN_STEPS)])
    return np.asarray(block), np.asarray(toks), run


@pytest.mark.parametrize("nproc,local", [(2, 2), (3, 1)], ids=["2x2", "3x1"])
def test_process_drill_matches_jax(tmp_path, nproc, local):
    from concurrent.futures import ThreadPoolExecutor

    from crispy_tpu_torch.parallel import multihost as mh
    from test_torch_train_step import ADAM_TOL, LOSS_RTOL, check_against_jax

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    argv = [sys.executable, __file__, str(local), str(tmp_path)]
    with ThreadPoolExecutor(1) as pool:  # the ranks run while the parent runs JAX
        ranks = pool.submit(mh.launch_local, argv, nproc, f"file://{tmp_path}/rendezvous",
                            RANK_TIMEOUT, tmp_path / "logs", env)
        block, toks, run = jax_references(nproc, local)
        logs = ranks.result()
    for r, log in enumerate(logs):
        assert f"[rank {r}] DRILL_OK backend=gloo" in log, log[-4000:]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(nproc)]
    for r, g in enumerate(got):
        assert int(g["devices"]) == nproc * local and str(g["backend"]) == "gloo"
        rows = slice(r * STREAMS_PER_PROC, (r + 1) * STREAMS_PER_PROC)
        assert np.abs(g["block"] - block[rows]).max() <= JAX_ATOL, r
        assert np.abs(g["batch"] - block[rows]).max() <= JAX_ATOL, r
        assert np.array_equal(g["tokens"], toks[r * ASR_PER_PROC:(r + 1) * ASR_PER_PROC]), r
        # every process ends the steps with the same loss curve and weights
        assert np.array_equal(g["losses"], got[0]["losses"]), r
        for k in run["params"]:
            assert np.array_equal(g[f"param:{k}"], got[0][f"param:{k}"]), (r, k)
    losses = got[0]["losses"]
    assert np.all(np.abs(losses - run["losses"]) <= LOSS_RTOL * np.abs(run["losses"]))
    noise = check_against_jax({k: got[0][f"param:{k}"] for k in run["params"]}, run, ADAM_TOL)
    print(f"{nproc} x {local}: losses {losses} (JAX {run['losses']}); weights with a gradient "
          f"below GRAD_RTOL of their tensor's largest: {noise}")


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), Path(sys.argv[2]))
