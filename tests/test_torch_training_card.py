"""RNNoise training on the card against the port's CPU path (``gpu`` tests:
they skip without a CUDA card; the CPU path is held to the JAX package by
tests/test_torch_training.py and tests/test_torch_train_step.py).

The training net's loss and gradients on the same batch, ``make_batch``'s
targets on the same draws (K2 and K3 launched once a batch), and
``train_model`` in corpus mode: the same loss curve and the kernels'
launches, one of K2 and K3 a step.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp.rnnoise import ops_kernels, pipeline, rnn_kernels, training
from crispy_tpu_torch.parallel import train as pt

pytestmark = pytest.mark.gpu

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # x each tensor's largest |g|
CURVE_RTOL = 1e-3  # train_model's losses: the card's targets and steps in another order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_loss_and_grads_card_vs_cpu(card):
    p = {k: (np.random.default_rng(2).standard_normal(v.shape) * 0.08).astype(np.float32)
         for k, v in pt.init_train_params().items()}
    batch = pt.synthetic_batch(4, 50, seed=3)
    out = []
    for dev in (card, torch.device("cpu")):
        step, to_dev, to_batch, optimizer = pt.make_train_step(device=dev)
        net = to_dev(p)
        loss = pt.loss_fn(net, to_batch(batch))
        loss.backward()
        out.append((float(loss.detach()), {n: q.grad.cpu().numpy()
                                           for n, q in net.named_parameters()}))
    (lg, gg), (lc, gc) = out
    assert abs(lg - lc) <= LOSS_RTOL * abs(lc)
    for k in gc:
        assert np.abs(gg[k] - gc[k]).max() <= GRAD_RTOL * np.abs(gc[k]).max(), k


def test_make_batch_card_vs_cpu(card):
    rd, pw = rnn_kernels.rd_scan.launches, ops_kernels.pitch_window_gather.launches
    g = training.make_batch(pipeline.make_params(None, card), np.random.default_rng(4), 2, 20)
    assert (rnn_kernels.rd_scan.launches - rd, ops_kernels.pitch_window_gather.launches - pw) == (1, 1)
    c = training.make_batch(pipeline.make_params(None, "cpu"), np.random.default_rng(4), 2, 20)
    assert all(v.device.type == "cuda" for v in g.values())
    assert torch.equal(g["mask"].cpu(), c["mask"]) and torch.equal(g["vad"].cpu(), c["vad"])
    gf, cf = g["features"].cpu().numpy(), c["features"].numpy()
    same = gf[..., 40] == cf[..., 40]
    # chip_smoke.py [14a]'s gate: the f32 HP biquad's rounding in quiet bands
    assert np.median(np.abs(gf - cf).max(-1)[same]) <= 1e-3


def test_train_model_corpus_card_vs_cpu(card):
    kw = dict(steps=4, batch_streams=2, frames=10, corpus_streams=4, steps_per_call=2,
              log_every=2)
    rd = rnn_kernels.rd_scan.launches
    mg, lg = training.train_model(device=None, **kw)
    assert rnn_kernels.rd_scan.launches - rd == 4
    mc, lc = training.train_model(device="cpu", **kw)
    assert mg.name == mc.name == "synthetic-4steps-corpus"
    assert np.max(np.abs(np.array(lg) - np.array(lc)) / np.abs(lc)) <= CURVE_RTOL
