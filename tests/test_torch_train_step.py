"""The port's RNNoise training net and step (crispy_tpu_torch.parallel.train)
held against the JAX package's parallel/train.py on the CPU.

The same NumPy parameters and batches go through the JAX functions and the
port's ``RNNoiseTrainNet``; optax's Adam and warmup-cosine schedule are held
against ``torch.optim.Adam`` and the port's copy of the schedule formula.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference is not installed")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from crispy_tpu import parallel as jparallel  # noqa: E402
from crispy_tpu.parallel import train as jtrain  # noqa: E402
from crispy_tpu_torch.dsp.rnnoise import training as tt  # noqa: E402
from crispy_tpu_torch import parallel as pparallel  # noqa: E402
from crispy_tpu_torch.parallel import train as pt  # noqa: E402
from torch_audio import one_torch_thread  # noqa: E402,F401

OUT_TOL = 1e-5  # gains and VAD, absolute: f32 products in another order over the recurrence
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # x each tensor's largest |g|
ADAM_TOL = 1e-6  # parameters after 5 Adam steps on identical gradients
SCHED_RTOL = 1e-6  # optax evaluates the schedule in f32


def random_params(seed):
    """Training params the size of the builtin net, drawn as train_model
    draws its init (0.08 N(0, 1)), biases included so they are exercised."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 0.08).astype(np.float32)
            for k, v in pt.init_train_params().items()}


def jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("B,F,seed", [(2, 10, 0), (3, 7, 5)])
def test_synthetic_batch_bit_equal(B, F, seed):
    j = jtrain.synthetic_batch(B, F, seed)
    t = pt.synthetic_batch(B, F, seed)
    assert j.keys() == t.keys()
    for k in j:
        assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k


def test_init_train_params_equal():
    j = jtrain.init_train_params()
    t = pt.init_train_params()
    assert list(j) == list(t) == list(pt.PARAM_KEYS)  # the init draws follow this order
    for k in j:
        assert np.array_equal(np.asarray(j[k]), t[k]), k
    assert sum(v.size for v in t.values()) == 87503  # the builtin RNNoise net


def test_params_round_trip_and_names():
    p = random_params(1)
    net = pt.RNNoiseTrainNet(p, "cpu")
    assert sorted(n for n, _ in net.named_parameters()) == sorted(pt.PARAM_KEYS)
    back = net.params_to_numpy()
    assert list(back) == list(pt.PARAM_KEYS)
    for k in p:
        assert np.array_equal(back[k], p[k]), k


@pytest.mark.parametrize("B,F", [(2, 10), (2, 100)])
def test_forward_matches_jax(B, F):
    p = random_params(2)
    feats = pt.synthetic_batch(B, F, seed=3)["features"]
    jg, jv = jtrain.forward(jax_params(p), jnp.asarray(feats))
    net = pt.RNNoiseTrainNet(p, "cpu")
    with torch.no_grad():
        tg, tv = pt.forward(net, torch.from_numpy(feats))
    assert tg.shape == (B, F, 22) and tv.shape == (B, F)
    assert np.abs(np.asarray(jg) - tg.numpy()).max() <= OUT_TOL
    assert np.abs(np.asarray(jv) - tv.numpy()).max() <= OUT_TOL


def jax_masked_loss(params, batch):
    """train_model's masked loss, a closure inside the JAX package's
    ``dsp/rnnoise/training.train_model``, as written there."""
    gains, vad = jtrain.forward(params, batch["features"])
    m = batch["mask"][..., None]
    g_loss = jnp.sum(m * (jnp.sqrt(gains + 1e-8) - jnp.sqrt(batch["gains"] + 1e-8)) ** 2)
    g_loss = g_loss / jnp.maximum(jnp.sum(m) * 22, 1.0) * 22
    v = jnp.clip(vad, 1e-6, 1 - 1e-6)
    v_loss = -(batch["vad"] * jnp.log(v) + (1 - batch["vad"]) * jnp.log(1 - v))
    v_loss = jnp.sum(batch["mask"] * v_loss) / jnp.maximum(jnp.sum(batch["mask"]), 1.0)
    return g_loss + 0.5 * v_loss


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(masked):
    p = random_params(4)
    batch = pt.synthetic_batch(2, 10, seed=6)
    if masked:  # silence frames left out, as train_model's batches carry them
        batch["mask"] = (np.random.default_rng(7).uniform(0, 1, (2, 10)) > 0.3).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(jax_masked_loss if masked else jtrain.loss_fn)(
        jax_params(p), {k: jnp.asarray(v) for k, v in batch.items()})
    net = pt.RNNoiseTrainNet(p, "cpu")
    loss = pt.loss_fn(net, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    grads = {n: q.grad.numpy() for n, q in net.named_parameters()}
    for k in pt.PARAM_KEYS:
        g = np.asarray(jgrads[k])
        assert np.abs(g).max() > 0, k
        assert np.abs(grads[k] - g).max() <= GRAD_RTOL * np.abs(g).max(), k


def test_adam_matches_optax_on_identical_gradients():
    p = random_params(7)
    rng = np.random.default_rng(8)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** rng.uniform(-6, 0)
              for k, v in p.items()} for _ in range(5)]
    opt = optax.adam(1e-3)
    jp_ = jax_params(p)
    state = opt.init(jp_)
    for g in grads:
        upd, state = opt.update(jax_params(g), state, jp_)
        jp_ = optax.apply_updates(jp_, upd)
    net = pt.RNNoiseTrainNet(p, "cpu")
    topt = pt.adam(net, 1e-3)
    named = dict(net.named_parameters())
    for g in grads:
        for k, v in g.items():
            named[k].grad = torch.from_numpy(v)
        topt.step()
    for k in pt.PARAM_KEYS:
        assert np.abs(named[k].detach().numpy() - np.asarray(jp_[k])).max() <= ADAM_TOL, k


@pytest.mark.parametrize("steps", [100, 4])
def test_schedule_matches_optax(steps):
    """train_model's schedule through LambdaLR: the lr of each of the run's
    steps against optax's at the count before increment (0.1 lr first)."""
    from torch.optim.lr_scheduler import LambdaLR

    lr = 1e-3
    warmup = max(steps // 50, 1)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=warmup, decay_steps=steps,
        end_value=lr * 0.05)
    net = pt.RNNoiseTrainNet(random_params(9), "cpu")
    opt = pt.adam(net, 1.0)
    sched = LambdaLR(opt, lambda k: tt.warmup_cosine_decay(
        k, lr * 0.1, lr, warmup, steps, lr * 0.05))
    for k in range(steps + 3):  # past the end: the schedule holds at end_value
        want = float(ref(k))
        got = opt.param_groups[0]["lr"]
        assert abs(got - want) <= SCHED_RTOL * want, (k, got, want)
        opt.step()
        sched.step()
    assert tt.warmup_cosine_decay(0, lr * 0.1, lr, warmup, steps, lr * 0.05) == pytest.approx(0.1 * lr)


def test_train_step_matches_jax():
    """make_train_step: one step on the CPU against the JAX step on a 1x1
    mesh. Adam's first update is lr g / (|g| + eps), so a weight whose
    gradient is rounding noise in both moves by up to 2 lr: parameters are
    compared on the weights whose JAX gradient is above that noise (1e-4 of
    the tensor's largest |g|) and the others are counted."""
    p = random_params(10)
    batch = pt.synthetic_batch(2, 10, seed=11)
    step, shard_params, shard_batch, opt = jtrain.make_train_step(jparallel.make_mesh(1))
    jp_ = shard_params(jax_params(p))
    jstate = opt.init(jp_)
    jgrads = jax.grad(jtrain.loss_fn)(jp_, shard_batch(batch))
    jp_, jstate, jloss = step(jp_, jstate, shard_batch(batch))
    tstep, to_dev, to_batch, optimizer = pt.make_train_step(device="cpu")
    net = to_dev(p)
    topt = optimizer(net)
    net, topt, loss = tstep(net, topt, to_batch(batch))
    assert loss.device.type == "cpu"
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    after = net.params_to_numpy()
    noise = 0
    for k in pt.PARAM_KEYS:
        g = np.abs(np.asarray(jgrads[k]))
        live = g > GRAD_RTOL * g.max()
        noise += int((~live).sum())
        assert np.abs(after[k] - np.asarray(jp_[k]))[live].max() <= ADAM_TOL, k
    print(f"weights with a gradient below {GRAD_RTOL} of their tensor's largest: {noise}")


# ---------------------------------------------------------------------------
# The step over a mesh (DP x TP) against the JAX step over a mesh
# ---------------------------------------------------------------------------

def jax_mesh_run(mesh, params, batches):
    """The JAX step over ``mesh`` (``make_train_step``'s shardings and Adam;
    train_model's masked loss for a batch with a mask) from ``params`` over
    ``batches``: {"losses", "params", "grads" (one dict a step)}."""
    _, shard_params, shard_batch, opt = jtrain.make_train_step(mesh)

    def make(loss):
        def one(p, state, batch):
            value, grads = jax.value_and_grad(loss)(p, batch)
            updates, state = opt.update(grads, state, p)
            return optax.apply_updates(p, updates), state, value, grads
        return jax.jit(one)

    steps = {True: make(jax_masked_loss), False: make(jtrain.loss_fn)}
    p = shard_params(jax_params(params))
    state = opt.init(p)
    losses, grads = [], []
    for b in batches:
        p, state, loss, g = steps["mask" in b](p, state, shard_batch(b))
        losses.append(float(loss))
        grads.append({k: np.asarray(v) for k, v in g.items()})
    return {"losses": np.array(losses), "params": {k: np.asarray(v) for k, v in p.items()},
            "grads": grads}


def check_against_jax(after, run, tol):
    """The port's parameters after the run's steps within ``tol`` of the
    JAX step's, on the weights whose JAX gradient is above rounding noise
    (GRAD_RTOL of the tensor's largest) at every step: Adam moves a weight
    by ~lr sign(g), so a gradient that is noise in both moves it either way
    (``test_train_step_matches_jax``). Returns how many weights were left out."""
    noise = 0
    for k, want in run["params"].items():
        live = np.ones(want.shape, bool)
        for g in run["grads"]:
            live &= np.abs(g[k]) > GRAD_RTOL * np.abs(g[k]).max()
        noise += int((~live).sum())
        assert after[k].shape == want.shape, k
        assert np.abs(after[k] - want)[live].max() <= tol, k
    return noise


def cpu_mesh(n, model_parallel):
    return jparallel.make_mesh(n, model_parallel=model_parallel), \
        pparallel.make_mesh(devices=["cpu"] * n, model_parallel=model_parallel)


MESHES = [(1, 1), (2, 1), (4, 1), (4, 2), (8, 2)]  # (devices, model_parallel)
MESH_STEPS = 2


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("n,mp", MESHES, ids=[f"{n // mp}x{mp}" for n, mp in MESHES])
def test_mesh_train_step_matches_jax(n, mp, masked):
    """make_train_step(mesh=...) at dp = 1, 2, 4 and (2, 2), (4, 2) against
    the JAX step over make_mesh(n): losses within LOSS_RTOL, parameters on
    the weights above gradient noise within ADAM_TOL, the replicas bit-equal,
    and the tensor-parallel pieces each on their row's device."""
    p = random_params(12)
    batches = []
    for s in range(MESH_STEPS):
        b = pt.synthetic_batch(4, 6, seed=13 + s)
        if masked:
            b["mask"] = (np.random.default_rng(s).uniform(0, 1, (4, 6)) > 0.3).astype(np.float32)
        batches.append(b)
    jmesh, mesh = cpu_mesh(n, mp)
    assert mesh.devices.shape == jmesh.devices.shape
    run = jax_mesh_run(jmesh, p, batches)
    step, to_params, to_batch, optimizer = pt.make_train_step(mesh=mesh)
    net = to_params(p)
    opt = optimizer(net)
    assert len(net.replicas) == mesh.dp
    losses = []
    for b in batches:
        net, opt, loss = step(net, opt, to_batch(b))
        losses.append(float(loss))
    assert np.all(np.abs(np.array(losses) - run["losses"]) <= LOSS_RTOL * np.abs(run["losses"]))
    after = net.params_to_numpy()
    noise = check_against_jax(after, run, ADAM_TOL)
    for rep in net.replicas[1:]:
        other = rep.params_to_numpy()
        assert all(np.array_equal(other[k], after[k]) for k in after)
    print(f"{mesh.devices.shape} masked={masked}: losses {losses} vs {run['losses']}; "
          f"{noise} weights below gradient noise left out")


@pytest.mark.parametrize("n,mp", [(4, 2), (8, 2), (2, 1)])
def test_tp_split_matches_jax_spec(n, mp):
    """param_spec and the net's pieces, key by key, against the sharding
    the JAX step gives each tensor (shard_params(...)[k].sharding.spec)."""
    p = random_params(14)
    jmesh, mesh = cpu_mesh(n, mp)
    _, shard_params, _, _ = jtrain.make_train_step(jmesh)
    jsharded = shard_params(jax_params(p))
    net = pt.make_train_step(mesh=mesh)[1](p)
    split = []
    for k in pt.PARAM_KEYS:
        spec = tuple(jsharded[k].sharding.spec)
        assert pt.param_spec(k, p[k].shape, mp) == spec, k
        lname, f = k.split(".")
        for i, rep in enumerate(net.replicas):
            t = getattr(getattr(rep, lname), f)
            pieces = list(t) if isinstance(t, torch.nn.ParameterList) else [t]
            assert len(pieces) == (mp if spec else 1), k
            assert [q.device for q in pieces] == list(mesh.grid[i][:len(pieces)]), k
            assert np.array_equal(np.concatenate([q.detach().numpy() for q in pieces], -1), p[k])
        split += [k] if spec else []
    # every tensor whose last axis divides splits; vad_output (width 1) stays whole
    assert split == ([k for k in pt.PARAM_KEYS if not k.startswith("vad_output")] if mp > 1 else [])


def test_mesh_pieces_own_their_storage():
    """On repeated entries of one device every replica and piece is a
    tensor of its own, so the run goes through the code several devices
    would."""
    net = pt.make_train_step(mesh=pparallel.make_mesh(devices=["cpu"] * 4))[1](random_params(15))
    ptrs = [q.data_ptr() for q in net.parameters()]
    assert len(ptrs) == len(set(ptrs))
    assert len(list(net.replicas[0].vad_gru.u)) == 2


def test_mesh_batch_must_split_evenly():
    mesh = pparallel.make_mesh(devices=["cpu"] * 4)  # (2, 2): two data rows
    step, _, to_batch, _ = pt.make_train_step(mesh=mesh)
    with pytest.raises(ValueError, match="does not split evenly over 2 data rows"):
        to_batch(pt.synthetic_batch(3, 4))
    assert [s for s, _ in pt.data_rows(mesh, 4)] == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        pt.make_train_step(device="cuda:0", mesh=mesh)


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_train_step()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.RNNoiseTrainNet(pt.init_train_params())
