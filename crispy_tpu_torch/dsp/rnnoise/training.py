"""RNNoise training: synthetic data -> gain/VAD targets -> quantized model.

The port of ``crispy_tpu/dsp/rnnoise/training.py``. Following the public
RNNoise recipe:

  * mixtures of clean (synthetic voiced harmonics with envelopes and
    silences) and noise (filtered broadband) at random SNR, made on the host
    with NumPy and SciPy in the JAX package's order of random draws (the
    same seed gives bit-equal arrays),
  * per-frame targets: ideal band gains sqrt(E_clean[b] / E_noisy[b])
    clipped to [0, 1] on the SAME analysis grid (the pipeline's own
    frontend computes both, on the device: K2 and K3 every step, K4 and K5
    under ``CRISPY_FUSED_SPECTRA=on``), VAD = ground-truth voicing,
  * the training step of ``parallel/train`` (smooth activations, autograd),
    Adam under optax's warmup-cosine schedule, then int8 quantization into
    the C weight layout (clip(round(256 w))/256) so inference matches the
    reference's arithmetic exactly.

`train_model()` returns an RNNoiseModel ready for weights.save();
``python -m crispy_tpu_torch.tools.train_rnnoise`` mints one on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ...device import resolve_device
from . import constants as C
from . import pipeline
from .weights import RNNoiseModel, from_c_layout

FRAME = C.FRAME_SIZE


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

def synth_batch(rng: np.random.Generator, S: int, F: int, sr: int = 48000):
    """Returns (clean [S, L], noisy [S, L], voiced [S, F]) in [-1, 1]."""
    L = F * FRAME
    t = np.arange(L) / sr
    clean, voiced = _synth_clean(rng, S, F, sr)
    noise = np.stack([_synth_noise(rng, L, sr, t) for _ in range(S)])
    noise /= np.maximum(np.abs(noise).max(axis=1, keepdims=True), 1e-6)
    snr_db = rng.uniform(-5, 25, (S, 1)).astype(np.float32)
    c_rms = np.sqrt(np.mean(clean**2, axis=1, keepdims=True) + 1e-9)
    n_rms = np.sqrt(np.mean(noise**2, axis=1, keepdims=True) + 1e-9)
    noise = noise * (c_rms / n_rms) * (10 ** (-snr_db / 20))
    noisy = np.clip(clean + noise, -1.0, 1.0)
    return clean, noisy, voiced


def _synth_clean(rng: np.random.Generator, S: int, F: int, sr: int = 48000):
    """Clean speech streams + per-frame speech-activity labels.

    Speech is voiced harmonics PLUS unvoiced fricative-like segments
    (band-limited 2-8 kHz noise bursts): a denoiser trained on harmonics
    only learns "noise-like energy = suppress" and eats real fricatives.
    Both kinds carry label 1 (the VAD target is speech activity, not
    voicing); the gain targets come from the actual clean signal either
    way. Matches the public RNNoise recipe's use of real (part-unvoiced)
    speech.
    """
    from scipy.signal import fftconvolve, lfilter

    L = F * FRAME
    t = np.arange(L) / sr
    clean = np.zeros((S, L), np.float32)
    voiced = np.zeros((S, F), np.float32)
    k = np.hanning(961)
    k /= k.sum()
    for s in range(S):
        f0 = rng.uniform(70, 320)
        n_harm = rng.integers(4, 12)
        phases = rng.uniform(0, 2 * np.pi, n_harm)
        sig_v = sum(
            (rng.uniform(0.3, 1.0) / (k_ + 1)) * np.sin(2 * np.pi * f0 * (k_ + 1) * t + phases[k_])
            for k_ in range(n_harm)
        )
        # fricative texture: 2-8 kHz resonator noise at harmonic-like RMS
        f_c = float(rng.uniform(2000, 8000))
        r = 1.0 - float(rng.uniform(0.05, 0.25))
        th = 2 * np.pi * f_c / sr
        sig_u = lfilter([1.0], [1.0, -2 * r * np.cos(th), r * r],
                        rng.standard_normal(L))
        sig_u *= np.sqrt(np.mean(sig_v**2) / np.maximum(np.mean(sig_u**2), 1e-12))
        # amplitude envelope with voiced / unvoiced / silent stretches
        env_v = np.zeros(F)
        env_u = np.zeros(F)
        f = 0
        while f < F:
            seg = int(rng.integers(5, 40))
            on = rng.random() < 0.7
            if on:
                a = rng.uniform(0.2, 1.0)
                if rng.random() < 0.3:  # unvoiced speech segment
                    env_u[f: f + seg] = a
                else:
                    env_v[f: f + seg] = a
            f += seg
        env_vs = fftconvolve(np.repeat(env_v, FRAME)[:L], k, mode="same")
        env_us = fftconvolve(np.repeat(env_u, FRAME)[:L], k, mode="same")
        clean[s] = (0.3 * (sig_v * env_vs + sig_u * env_us)).astype(np.float32)
        voiced[s] = (env_v + env_u > 0.05).astype(np.float32)
    return clean, voiced


def _synth_noise(rng: np.random.Generator, L: int, sr: int,
                 t: np.ndarray) -> np.ndarray:
    """One noise stream from a random mix of synthetic families.

    No real noise corpora are reachable in this environment (zero egress),
    so diversity comes from families modeled on the common real-world
    classes: spectrally tilted broadband (fans/wind), band-limited hiss,
    babble (competing harmonic talkers), mains hum + harmonics, impulsive
    clicks, and burst-modulated (non-stationary) broadband.
    """
    from scipy.signal import lfilter

    kinds = rng.choice(6, size=rng.integers(1, 3), replace=False)
    parts = []
    for kind in kinds:
        if kind == 0:  # tilted broadband (the original family)
            tilt = float(rng.uniform(0.0, 0.95))
            x = lfilter([1.0], [1.0, -tilt], rng.standard_normal(L))
        elif kind == 1:  # band-limited hiss (2nd-order resonator)
            f_c = float(rng.uniform(300, 8000))
            bw = float(rng.uniform(0.02, 0.3))
            r = 1.0 - bw
            th = 2 * np.pi * f_c / sr
            x = lfilter([1.0], [1.0, -2 * r * np.cos(th), r * r],
                        rng.standard_normal(L))
        elif kind == 2:  # babble: 3-6 low-level harmonic "talkers"
            x = np.zeros(L)
            for _ in range(int(rng.integers(3, 7))):
                f0 = float(rng.uniform(90, 280))
                ph = float(rng.uniform(0, 2 * np.pi))
                env = np.abs(lfilter([1e-3], [1.0, -0.999],
                                     rng.standard_normal(L)))
                x += env * np.sin(2 * np.pi * f0 * t + ph)
        elif kind == 3:  # mains hum + harmonics with slow AM
            base = float(rng.choice([50.0, 60.0]))
            x = np.zeros(L)
            for k in range(1, int(rng.integers(3, 8))):
                x += (1.0 / k) * np.sin(2 * np.pi * base * k * t
                                        + float(rng.uniform(0, 2 * np.pi)))
            x *= 1.0 + 0.3 * np.sin(2 * np.pi * float(rng.uniform(0.2, 2.0)) * t)
        elif kind == 4:  # impulsive clicks (sparse impulses, decaying tails)
            x = np.zeros(L)
            n_clicks = int(rng.integers(2, max(3, L // 24000) + 4))
            pos = rng.integers(0, L, n_clicks)
            x[pos] = rng.uniform(-1, 1, n_clicks)
            x = lfilter([1.0], [1.0, -float(rng.uniform(0.9, 0.995))], x)
        else:  # burst-modulated broadband (non-stationary)
            gate = (lfilter([1e-2], [1.0, -0.9995],
                            rng.standard_normal(L)) > 0).astype(np.float64)
            k = np.hanning(2401)
            from scipy.signal import fftconvolve

            gate = fftconvolve(gate, k / k.sum(), mode="same")
            x = gate * rng.standard_normal(L)
        m = np.abs(x).max()
        parts.append(x / m if m > 1e-9 else x)
    w = rng.dirichlet(np.ones(len(parts)))
    return sum(wi * p for wi, p in zip(w, parts)).astype(np.float32)


# ---------------------------------------------------------------------------
# Targets through the pipeline's own frontend
# ---------------------------------------------------------------------------

def _clean_band_energy(params, state, block):
    """Band energies of the clean signal on the same HP/window grid."""
    S, L = block.shape
    F = L // FRAME
    x = (block.to(torch.float32) * 32768.0).reshape(S, F, FRAME)
    state, hp = pipeline._hp_biquad(params, state, x)
    ext = torch.cat([state["hp_tail"], hp.reshape(S, -1)], dim=-1)
    state["hp_tail"] = ext[:, -(pipeline.HIST + 1):]
    awin = pipeline._windows(ext[:, 1 + pipeline.HIST - FRAME:], FRAME, pipeline.WIN, F)
    Xr, Xi = pipeline._spectrum(params, awin)
    return state, pipeline._band_energy(params, Xr, Xi)


@torch.no_grad()
def _batch_targets(params, clean: torch.Tensor, noisy: torch.Tensor):
    """(features, gains, mask) on the device of the audio; nothing is read
    back to the host."""
    dev = noisy.device
    _, fr = pipeline.frontend_block(params, pipeline.init_state(noisy.shape[0], dev), noisy)
    _, Ec = _clean_band_energy(params, pipeline.init_state(clean.shape[0], dev), clean)
    gains = torch.sqrt(torch.clamp(Ec / torch.clamp(fr["Ex"], min=1e-8), 0.0, 1.0))
    return fr["feats"], gains, (~fr["silence"]).to(torch.float32)


def make_batch(params, rng: np.random.Generator, S: int, F: int) -> Dict[str, torch.Tensor]:
    """features [S,F,42], gains [S,F,22], vad [S,F], mask [S,F] on the
    device of ``params``: clean and noisy audio go up in one copy, and
    nothing comes back."""
    return _device_batch(params, *synth_batch(rng, S, F))


def _device_batch(params, clean: np.ndarray, noisy: np.ndarray,
                  voiced: np.ndarray) -> Dict[str, torch.Tensor]:
    """``make_batch`` of host audio already drawn."""
    dev = params["half_window"].device
    audio = torch.from_numpy(np.stack([clean, noisy])).to(dev)
    feats, gains, mask = _batch_targets(params, audio[0], audio[1])
    return {
        "features": feats,
        "gains": gains,
        "vad": torch.from_numpy(voiced.astype(np.float32)).to(dev),
        "mask": mask,
    }


def build_corpus(seed: int, streams: int, F: int, sr: int = 48000,
                 chunk: int = 32) -> Dict[str, np.ndarray]:
    """One-time host generation of a reusable training pool.

    Training from a corpus decouples data generation (~0.8 s per 32-stream
    batch on one host core) from the device step: `streams` clean signals
    and `streams` max-normalized noise streams are generated ONCE and stored
    int16 (the natural audio wire; half the device memory), and training
    then recombines clean x noise x SNR on the device: `streams`^2 x
    continuous-SNR effective mixtures from O(streams) host work.
    """
    L = F * FRAME
    t = np.arange(L) / sr
    rng = np.random.default_rng(seed)
    clean = np.empty((streams, L), np.int16)
    noise = np.empty((streams, L), np.int16)
    voiced = np.empty((streams, F), np.float32)
    done = 0
    while done < streams:
        S = min(chunk, streams - done)
        c, v = _synth_clean(rng, S, F, sr)
        n = np.stack([_synth_noise(rng, L, sr, t) for _ in range(S)])
        n /= np.maximum(np.abs(n).max(axis=1, keepdims=True), 1e-6)
        clean[done:done + S] = np.clip(np.round(c * 32768.0), -32768, 32767)
        noise[done:done + S] = np.clip(np.round(n * 32767.0), -32768, 32767)
        voiced[done:done + S] = v
        done += S
    return {"clean": clean, "noise": noise, "voiced": voiced}


# ---------------------------------------------------------------------------
# Training + quantization
# ---------------------------------------------------------------------------

def quantize_to_model(train_params: Dict[str, np.ndarray], name: str = "trained") -> RNNoiseModel:
    """Round to the reference's int8/256 grid and build an RNNoiseModel.
    ``train_params`` holds NumPy arrays (``RNNoiseTrainNet.params_to_numpy``)."""
    def q(x):
        return np.clip(np.round(np.asarray(x, np.float64) * 256.0), -128, 127).astype(np.float32)

    arrays = {
        "input_dense_weights": q(train_params["input_dense.w"]).reshape(-1),
        "input_dense_bias": q(train_params["input_dense.b"]),
        "denoise_output_weights": q(train_params["denoise_output.w"]).reshape(-1),
        "denoise_output_bias": q(train_params["denoise_output.b"]),
        "vad_output_weights": q(train_params["vad_output.w"]).reshape(-1),
        "vad_output_bias": q(train_params["vad_output.b"]),
    }
    for g in ("vad_gru", "noise_gru", "denoise_gru"):
        # our [in, 3N] layout flattens directly into the C stride-3N layout
        arrays[f"{g}_weights"] = q(train_params[f"{g}.w"]).reshape(-1)
        arrays[f"{g}_recurrent_weights"] = q(train_params[f"{g}.u"]).reshape(-1)
        arrays[f"{g}_bias"] = q(train_params[f"{g}.b"]).reshape(-1)
    return from_c_layout(arrays, name=name)


def warmup_cosine_decay(count: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int, end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) at step ``count``:
    linear from init_value to peak_value over warmup_steps, then cosine to
    end_value; ``decay_steps`` counts the warmup."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    if count < warmup_steps:
        frac = 1.0 - max(count, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    t = min(count - warmup_steps, decay_steps - warmup_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def _remix(pools, idx_c, idx_n, snr_db):
    """Clean and noise rows gathered from the int16 pools and mixed at
    ``snr_db``, on the device: (clean, noisy, vad)."""
    cp, np_, vp = pools
    clean = cp.index_select(0, idx_c).to(torch.float32) / 32768.0
    noise = np_.index_select(0, idx_n).to(torch.float32) / 32768.0
    c_rms = torch.sqrt(torch.mean(clean ** 2, dim=1, keepdim=True) + 1e-9)
    n_rms = torch.sqrt(torch.mean(noise ** 2, dim=1, keepdim=True) + 1e-9)
    noise = noise * (c_rms / n_rms) * 10.0 ** (-snr_db / 20.0)
    return clean, torch.clamp(clean + noise, -1.0, 1.0), vp.index_select(0, idx_c)


def _corpus_call(step, net, opt, sched, shards, join) -> torch.Tensor:
    """``n`` steps of ``step`` from the pools. ``shards`` holds one
    (pools, pipeline params, idx [2, n, b] clean and noise rows, snr [n, b, 1]
    dB) per data row, on the row's device; ``join`` makes the step's batch
    of the rows' dicts. Returns the n losses, on the first row's device."""
    n = shards[0][3].shape[0]
    ls = torch.zeros(n, dtype=torch.float32, device=shards[0][3].device)
    for i in range(n):
        parts = []
        for pools, pipe_params, idx, snr in shards:
            clean, noisy, vad = _remix(pools, idx[0, i], idx[1, i], snr[i])
            feats, gains, mask = _batch_targets(pipe_params, clean, noisy)
            parts.append({"features": feats, "gains": gains, "mask": mask, "vad": vad})
        net, opt, ls[i] = step(net, opt, join(parts))
        sched.step()
    return ls


def train_model(
    steps: int = 300,
    batch_streams: int = 16,
    frames: int = 100,
    seed: int = 0,
    learning_rate: float = 1e-3,
    mesh=None,
    log_every: int = 50,
    corpus_streams: int | None = None,
    steps_per_call: int = 25,
    device=None,
) -> Tuple[RNNoiseModel, list]:
    """Train on synthetic mixtures on ``device`` (default the card); returns
    (quantized model, loss curve).

    With `corpus_streams` set, training is device-resident: a fixed int16
    pool (build_corpus) goes to the device once and every step gathers a
    fresh clean x noise x SNR recombination there; the draws of a call of
    `steps_per_call` steps go up in one copy, and the call's losses come
    back in one read when it is logged. The default (None) generates each
    step's batch on the host.

    `mesh` (a ``parallel.Mesh`` or a ``multihost.ProcessMesh``; ``device``
    then None or its first device) trains data-parallel, and
    tensor-parallel over each data row's model devices
    (``parallel.train.make_train_step``): `batch_streams` must split evenly
    over the job's data rows. Every process makes the unsharded run's
    random draws, in its order, and keeps its own rows: in host mode each
    process synthesizes the whole batch on the host (the synthesis repeats
    in every process) and the targets run on its rows only, each data row's
    on its device; in corpus mode the pools go once to each distinct device
    and each row gathers its own mixtures. The loss curve and the model are
    the unsharded run's, to f32 rounding.
    """
    from torch.optim.lr_scheduler import LambdaLR

    from ...parallel import check_device
    from ...parallel import train as ptrain
    from ...parallel.multihost import as_process_mesh

    if mesh is None:
        dev = resolve_device(device)
        rows = [(slice(None), dev)]
    else:
        local = as_process_mesh(mesh).local
        check_device(local, device)
        dev = resolve_device(local.first)
        rows = ptrain.data_rows(mesh, batch_streams)
    # DSP tables only (weights unused here), one copy a device
    pipes = {d: pipeline.make_params(None, d) for d in dict.fromkeys(d for _, d in rows)}
    rng = np.random.default_rng(seed)

    if corpus_streams is not None:
        # whole calls only, as the JAX package runs them
        steps = -(-steps // steps_per_call) * steps_per_call

    # small random init (NOT the test model: train from scratch), drawn over
    # the keys in the JAX dict's order
    tparams = {}
    init_rng = np.random.default_rng(seed + 1)
    for k, v in ptrain.init_train_params().items():
        if k.endswith(".w") or k.endswith(".u"):
            tparams[k] = (init_rng.standard_normal(v.shape) * 0.08).astype(np.float32)
        else:
            tparams[k] = np.zeros_like(v)
    # The step takes the masked loss (silence frames ignored): the batches
    # carry a mask. Warmup + cosine decay: at the short default runs this is
    # ~constant LR (decay barely bites); at long retrains the annealed tail
    # settles the quantization-sensitive gains layer instead of bouncing at
    # 1e-3. The optimizer's lr is 1, so each step's lr is the schedule's
    # value; like optax, step k uses the schedule at count k - 1 (0.1 lr first).
    step, to_device_params, _, optimizer = ptrain.make_train_step(dev, 1.0, mesh=mesh)
    net = to_device_params(tparams)
    opt = optimizer(net)
    warmup = max(steps // 50, 1)
    sched = LambdaLR(opt, lambda k: warmup_cosine_decay(
        k, learning_rate * 0.1, learning_rate, warmup, steps, learning_rate * 0.05))

    def join(parts):
        return parts[0] if mesh is None else parts

    losses = []
    if corpus_streams is not None:
        corpus = build_corpus(seed + 7919, corpus_streams, frames)
        pools = {d: tuple(torch.from_numpy(corpus[k]).to(d) for k in ("clean", "noise", "voiced"))
                 for d in pipes}
        P = corpus_streams
        for call0 in range(0, steps, steps_per_call):
            idx_c = rng.integers(0, P, (steps_per_call, batch_streams))
            idx_n = rng.integers(0, P, (steps_per_call, batch_streams))
            snr = rng.uniform(-5, 25, (steps_per_call, batch_streams, 1)).astype(np.float32)
            shards = [(pools[d], pipes[d],
                       torch.from_numpy(np.stack([idx_c[:, s], idx_n[:, s]])).to(d),
                       torch.from_numpy(np.ascontiguousarray(snr[:, s])).to(d))
                      for s, d in rows]
            ls = _corpus_call(step, net, opt, sched, shards, join)
            if (call0 // steps_per_call) % max(log_every // steps_per_call, 1) == 0 \
                    or call0 + steps_per_call >= steps:
                losses.append(float(ls.mean()))  # one read per logged call
        model = quantize_to_model(net.params_to_numpy(), name=f"synthetic-{steps}steps-corpus")
        return model, losses

    for i in range(steps):
        clean, noisy, voiced = synth_batch(rng, batch_streams, frames)
        batch = join([_device_batch(pipes[d], clean[s], noisy[s], voiced[s]) for s, d in rows])
        net, opt, loss = step(net, opt, batch)
        sched.step()
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))  # the only host read per log window
    model = quantize_to_model(net.params_to_numpy(), name=f"synthetic-{steps}steps")
    return model, losses


def snr_improvement(model: RNNoiseModel, seed: int = 123, F: int = 60, device=None) -> float:
    """Denoise a held-out mixture on ``device`` (default the card); returns
    the SNR gain in dB (clean reference).

    The pipeline output lags the input by one frame (windowed analysis/
    synthesis); the comparison aligns for that.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    clean, noisy, _ = synth_batch(rng, 2, F)
    # remix at a fixed 0 dB input SNR (the representative denoising regime;
    # at very clean inputs the gain-based approach hits its distortion floor)
    noise = noisy - clean
    c = np.sqrt(np.mean(clean ** 2, axis=1, keepdims=True))
    n = np.sqrt(np.mean(noise ** 2, axis=1, keepdims=True) + 1e-12)
    noisy = np.clip(clean + noise * (c / n), -1.0, 1.0)
    params = pipeline.make_params(model, dev)
    out = pipeline.denoise_batch(noisy, params=params, block_frames=F, device=dev)
    s0, s1 = 5 * FRAME, (F - 2) * FRAME
    ref = clean[:, s0 - FRAME: s1 - FRAME]

    def snr(x):
        err = x - ref
        return 10 * np.log10(np.mean(ref ** 2) / np.maximum(np.mean(err ** 2), 1e-12))

    return float(snr(out[:, s0:s1]) - snr(noisy[:, s0 - FRAME: s1 - FRAME]))
