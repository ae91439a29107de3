#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crispy_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

  1. card and build: the card's name and power limit, then the kernels built
     from ``crispy_tpu_torch/csrc`` (nvcc, one job per source in parallel);
  2. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (S=128 streams, F=500 frames), with their times, bounds
     and, where one PyTorch call computes the same function, its time (for
     the spectra kernels, torch.fft and the bare torch.matmul product); K1
     twice: its resident variant on the builtin weights and its f32 variant
     on the same weights moved off the fp16 grid; K2 bit-exact on random
     rows and on rows heavy in continuations, with its own device time
     (torch.profiler) beside its design floor;
  3. the default (FFT) path: a 2-channel 30 s 48 kHz 16-bit WAV through
     ``denoise_file`` (int16 wire) and the same samples through
     ``denoise_array`` (f32), on the card, held against the port's CPU path,
     and its first 4 s against the port's copy of the NumPy oracle; the
     launch counts of K1 (resident) to K3 must have risen in this phase,
     K4-K6's and the f32 K1's must stay at zero;
  4. the fused-spectra path (``CRISPY_FUSED_SPECTRA=on``): the same WAV and
     samples through the same entry points, held against the port's CPU
     fused path on the first two blocks (10 s), the card's FFT path on all
     of it and the oracle on its first 4 s; all six kernels' launch counts
     must rise, the f32 K1's stay at zero;
  5. throughput: ``denoise_batch`` at S=128, F=500 on the card, 20 blocks
     per stream, timed in 3 calls (median and spread), and the block step
     of each spectra path by CUDA events.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``crispy_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
S_MAIN, F_MAIN = 128, 500  # denoise_batch's default block at 128 streams
SLICE_SECONDS = 30  # length of the stereo WAV of phase 3
THROUGHPUT_BLOCKS = 20  # blocks per stream in one timed denoise_batch call
THROUGHPUT_RUNS = 3

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# K2's design floor per frame, counted from the dependent chain in
# csrc/rd_scan.cu: 7 ALU operations at ~4 clocks, a ballot and a shuffle at
# ~25 clocks each.
RD_CHAIN_CLOCKS = 7 * 4 + 25 + 25

K1_TOL = 1e-5  # f32 sums in another order than cuBLAS, over a 500-frame recurrence
SPEC_TOL = 1e-5  # K4-K6, x max|plain|: f32 sums of 960-2048 terms in another order
EX_RTOL = 1e-4  # K4, K5 band energies, relative
SPEC_SCALE = 9000.0  # input scale of the JAX package's own K4-K6 tests
F32_TOL = 1.5e-4  # the JAX package's own oracle tolerance
ORACLE_SECONDS = 4  # audio held against the NumPy oracle in phases 3 and 4
I16_TOL = 1  # LSB


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time of the kernel whose name holds ``kernel``, per launch,
    over iters calls of fn() by torch.profiler: the kernel's own time, with
    no host gaps between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and kernel in e.key]
    n = sum(e.count for e in evs)
    if n != iters:
        fail(f"the profile holds {n} launches of {kernel}, not {iters}")
    return sum(e.self_device_time_total for e in evs) / 1e3 / n


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rfft_flops(n: int) -> float:
    """Operations of an n-point real FFT (or its inverse) by the usual
    nominal count, 2.5 n log2 n: the least the spectra kernels' DFTs need,
    whatever the kernels execute."""
    return 2.5 * n * math.log2(n)


def speechlike(n: int, rng, f0: float, sr: int = 48000, level: float = 0.4) -> np.ndarray:
    """Harmonic tone with a slow amplitude wobble plus a little noise."""
    t = np.arange(n) / sr
    sig = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * t + 0.13 * k) for k in range(1, 9))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t + f0))
    sig = sig + 0.03 * rng.standard_normal(n)
    return (level * sig / np.max(np.abs(sig))).astype(np.float32)


def spectra_rows(torch, pipeline, fk, params, dev, rng):
    """K4, K5 and K6 against their plain versions at S=128, F=500.

    Their bounds count the operations of the function, an FFT per window.
    library_ms is, for K4 and K5, torch.fft.rfft of the windowed frames (no
    padded layout, no band energies), for K6 torch.fft.irfft of the spectra
    (no window, no overlap-add), with torch.matmul's bare product against
    the table printed beside it."""
    S, F, FR, WIN = S_MAIN, F_MAIN, pipeline.FRAME, pipeline.WIN
    rows = []
    ext = torch.from_numpy(rng.standard_normal((S, pipeline.HIST + 1 + F * FR),
                                               dtype=np.float32) * SPEC_SCALE).to(dev)
    ext_a = ext[:, 1 + pipeline.HIST - FR:]  # in place, as the pipeline passes it
    wins = torch.from_numpy(rng.standard_normal((S, F, WIN), dtype=np.float32)
                            * SPEC_SCALE).to(dev)
    mem = torch.from_numpy(rng.standard_normal((S, FR), dtype=np.float32)
                           * SPEC_SCALE).to(dev)
    band, dft_pad = params["band_e_pad"], params["dft_fwd_pad"]
    inva, invb = params["dft_inv_a"], params["dft_inv_b"]
    nb, nf = band.shape[1], pipeline.NFREQ
    # per window: the window, the FFT, re^2 + im^2, a multiply-add per band weight
    fwd_flops = S * F * (WIN + rfft_flops(WIN) + 3.0 * nf + 2.0 * int((band != 0).sum()))
    # per frame: the inverse FFT, the window, the overlap-add
    inv_flops = S * F * (rfft_flops(WIN) + WIN + FR)
    yx_bytes = S * F * (fk.YPAD + nb) * 4  # Y and Ex written
    inv_cat = torch.cat([inva, invb], dim=1)
    awin = ext_a.unfold(1, WIN, FR).reshape(S * F, WIN)  # a copy, for the product alone
    window = torch.cat([params["half_window"], params["half_window"].flip(0)])
    fft_in = {"fwd_spectrum_bands": awin * window, "win_spectrum_bands": wins * window}

    cases = [
        ("fwd_spectrum_bands", "spectrum_fwd.cu", "pallas_frontend.py:132",
         lambda: fk.fwd_spectrum_bands(ext_a, dft_pad, band, F),
         lambda: fk.fwd_spectrum_bands_reference(ext_a, dft_pad, band, F),
         lambda: torch.matmul(awin, dft_pad), fwd_flops,
         S * (F + 1) * FR * 4 + (dft_pad.numel() + band.numel()) * 4 + yx_bytes),
        ("win_spectrum_bands", "spectrum_fwd.cu", "pallas_frontend.py:196",
         lambda: fk.win_spectrum_bands(wins, dft_pad, band),
         lambda: fk.win_spectrum_bands_reference(wins, dft_pad, band),
         lambda: torch.matmul(wins.reshape(S * F, WIN), dft_pad), fwd_flops,
         (wins.numel() + dft_pad.numel() + band.numel()) * 4 + yx_bytes),
    ]
    for name, src, replaces, kern, plain, lib, flops, nbytes in cases:
        Y, Ex = kern()
        rY, rEx = plain()
        torch.cuda.synchronize()
        err = float((Y - rY).abs().max())
        ymax = float(rY.abs().max())
        pad = max(float(Y[..., 481:512].abs().max()), float(Y[..., 993:].abs().max()))
        ex_rel = float(((Ex - rEx).abs() / rEx.abs()).max())
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 5)
        matmul_ms = cuda_ms(lib, 5)
        frames = fft_in[name]
        library_ms = cuda_ms(lambda: torch.fft.rfft(frames, dim=-1), 5)
        b_ms, b_by = bound(nbytes, flops)
        print(f"{name}: max|Y kernel-plain|={err:.3e} (tol {SPEC_TOL} x {ymax:.1f}), "
              f"Ex max rel {ex_rel:.3e} (tol {EX_RTOL}), pad max {pad}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.fft.rfft of the windowed frames "
              f"{library_ms:.4f} ms, torch.matmul product only {matmul_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP as FFTs, {nbytes / 1e6:.1f} MB)")
        if not (err <= SPEC_TOL * ymax and ex_rel <= EX_RTOL and pad == 0.0):
            fail(f"{name} differs from its plain version: Y {err}, Ex rel {ex_rel}, pad {pad}")
        rows.append({"name": name, "route": "cuda", "source": f"crispy_tpu_torch/csrc/{src}",
                     "replaces": f"crispy_tpu/dsp/rnnoise/{replaces}", "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})

    # K6 on the analysis spectra K4's plain version gives for ext.
    Yin = fk.fwd_spectrum_bands_reference(ext_a, dft_pad, band, F)[0].contiguous()
    out, new_mem = fk.inv_spectrum_ola(Yin, inva, invb, mem)
    rout, rmem = fk.inv_spectrum_ola_reference(Yin, inva, invb, mem)
    torch.cuda.synchronize()
    err = float((out - rout).abs().max())
    err_mem = float((new_mem - rmem).abs().max())
    omax, mmax = float(rout.abs().max()), float(rmem.abs().max())
    ms = cuda_ms(lambda: fk.inv_spectrum_ola(Yin, inva, invb, mem), 10)
    plain_ms = cuda_ms(lambda: fk.inv_spectrum_ola_reference(Yin, inva, invb, mem), 5)
    yflat = Yin.reshape(S * F, fk.YPAD)
    matmul_ms = cuda_ms(lambda: torch.matmul(yflat, inv_cat), 5)
    Yc = torch.complex(Yin[..., :nf], Yin[..., fk.IM0: fk.IM0 + nf])
    library_ms = cuda_ms(lambda: torch.fft.irfft(Yc, n=WIN, dim=-1), 5)
    nbytes = (Yin.numel() + inva.numel() + invb.numel() + 2 * mem.numel() + rout.numel()) * 4
    b_ms, b_by = bound(nbytes, inv_flops)
    print(f"inv_spectrum_ola: max|out kernel-plain|={err:.3e} (tol {SPEC_TOL} x {omax:.1f}), "
          f"new_mem {err_mem:.3e} (tol {SPEC_TOL} x {mmax:.1f}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.fft.irfft of the spectra {library_ms:.4f} ms, "
          f"torch.matmul product only {matmul_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{inv_flops / 1e9:.2f} GFLOP as FFTs, {nbytes / 1e6:.1f} MB)")
    if not (err <= SPEC_TOL * omax and err_mem <= SPEC_TOL * mmax):
        fail(f"inv_spectrum_ola differs from its plain version: out {err}, new_mem {err_mem}")
    rows.append({"name": "inv_spectrum_ola", "route": "cuda",
                 "source": "crispy_tpu_torch/csrc/spectrum_inv.cu",
                 "replaces": "crispy_tpu/dsp/rnnoise/pallas_frontend.py:261",
                 "max_abs_err": max(err, err_mem), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
    return rows


def kernel_phase(torch, pipeline, rk, ok, fk, params, dev):
    """Phase 2: each kernel against its plain version at S=128, F=500."""
    from crispy_tpu_torch.dsp.rnnoise import rd_rows

    rng = np.random.default_rng(SEED)
    S, F = S_MAIN, F_MAIN
    f32 = np.float32
    rows = []

    # K1: the GRU network scan, the resident variant on the model's weights
    # (on the fp16 grid) and the f32 variant on the same weights moved off it.
    feats = torch.from_numpy(rng.standard_normal((S, F, 42)).astype(f32)).to(dev)
    silence = torch.from_numpy(rng.random((S, F)) < 0.2).to(dev)
    state = pipeline.init_state(S, dev)
    for k in ("gru_vad", "gru_noise", "gru_denoise", "lastg"):
        state[k] = torch.from_numpy(rng.random(tuple(state[k].shape)).astype(f32)).to(dev)
    off_grid = dict(params)
    for k in rk._MATRICES:
        move = rng.uniform(-1e-3, 1e-3, tuple(params[k].shape)).astype(f32)
        off_grid[k] = (params[k] + torch.from_numpy(move).to(dev)).contiguous()
    if not rk.exact_in_half(params) or rk.exact_in_half(off_grid):
        fail("K1: the builtin weights must be exact in fp16 and the moved ones not")
    macs = sum(params[k].numel() for k in rk._MATRICES)
    nbytes = (feats.numel() * 4 + silence.numel() + 2 * S * rk._STATE * 4
              + sum(params[k].numel() * 4 for k in rk._NN_WEIGHTS)
              + S * F * (2 * rk.NB + 1) * 4)
    b_ms, b_by = bound(nbytes, 2.0 * macs * S * F)
    # The resident design's own floor: one SM reads the packed fp16 weights
    # from shared memory once per frame at 128 bytes per clock.
    packed_bytes = rk.pack_half_weights(params).numel() * 2
    mhz = sm_clock_mhz()
    floor_ms = F * packed_bytes / 128 / (mhz * 1e6) * 1e3
    floor = (f"; resident design floor {floor_ms:.4f} ms ({packed_bytes} B of fp16 weights "
             f"per frame at 128 B/clock, {mhz:.0f} MHz)")
    for name, p, want in (("nn_scan", params, (1, 0)), ("nn_scan_f32", off_grid, (0, 1))):
        before = (rk.nn_scan.launches, rk.nn_scan.launches_f32)
        (a1, a2, a3), sa = rk.nn_scan(p, state, feats, silence)
        ran = (rk.nn_scan.launches - before[0], rk.nn_scan.launches_f32 - before[1])
        if ran != want:
            fail(f"{name}: the wrong K1 variant ran ({ran})")
        (b1, b2, b3), sb = rk.nn_scan_reference(p, state, feats, silence)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in
                  [(a1, b1), (a2, b2), (a3, b3)] + [(sa[k], sb[k]) for k in sa])
        ms = cuda_ms(lambda: rk.nn_scan(p, state, feats, silence), 10)
        plain_ms = cuda_ms(lambda: rk.nn_scan_reference(p, state, feats, silence), 1, 0)
        print(f"K1 {name}: max|kernel-plain|={err:.3e} (tol {K1_TOL}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {macs} MACs/frame, "
              f"{nbytes / 1e6:.1f} MB){floor if name == 'nn_scan' else ''}")
        if not err <= K1_TOL:
            fail(f"K1 {name} differs from its plain version by {err}")
        rows.append({"name": name, "route": "cuda", "source": "crispy_tpu_torch/csrc/nn_scan.cu",
                     "replaces": "crispy_tpu/dsp/rnnoise/pallas_rnn.py:114", "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

    # K2: the remove_doubling continuation scan, bit-exact on random rows and
    # on rows heavy in continuations, timed on the random ones.
    rd_cases = {}
    for kind, (rows_np, lp_np, lg_np) in (("random", rd_rows.random_rows(rng, S, F)),
                                          ("continuation", rd_rows.continuation_rows(rng, S, F))):
        args = tuple(torch.from_numpy(x).to(dev) for x in (rows_np, lp_np, lg_np))
        pa = rk.rd_scan(*args)
        pb = rk.rd_scan_reference(*args)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        if err != 0.0 or not all(torch.equal(x, y) for x, y in zip(pa, pb)):
            fail(f"K2 is not bit-exact on the {kind} rows: {err}")
        # share of candidates within 2 of the previous frame's half-period
        prev = torch.cat([args[1][:, None], pb[0][:, :-1]], dim=1)
        near = (args[0][..., :14] - torch.floor(prev * 0.5)[..., None]).abs() <= 2
        rd_cases[kind] = (args, err, float(near.float().mean()))
    packed, lp0, lg0 = rd_cases["random"][0]
    err = max(e for _, e, _ in rd_cases.values())
    ms = cuda_ms(lambda: rk.rd_scan(packed, lp0, lg0), 50)
    dev_ms = device_ms(lambda: rk.rd_scan(packed, lp0, lg0), 50, "rd_scan_kernel")
    plain_ms = cuda_ms(lambda: rk.rd_scan_reference(packed, lp0, lg0), 2, 1)
    nbytes = packed.numel() * 4 + 2 * S * 4 + (S * F + 2 * S) * 4
    flops = 14 * 12 * S * F  # ~12 f32 ops per candidate and frame
    b_ms, b_by = bound(nbytes, flops)
    rd_floor_ms = F * RD_CHAIN_CLOCKS / (mhz * 1e6) * 1e3
    print(f"K2 rd_scan: max|kernel-plain|={err:.3e} (bit-exact required) on random rows and "
          f"on continuation-heavy rows (candidates within 2 of the previous half-period: "
          f"{rd_cases['random'][2]:.3f} and {rd_cases['continuation'][2]:.3f}); kernel "
          f"{ms:.4f} ms (CUDA events over 50 calls), device time {dev_ms:.4f} ms "
          f"(torch.profiler, {dev_ms * mhz * 1e3 / F:.0f} clocks a frame at {mhz:.0f} MHz), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {nbytes / 1e6:.2f} MB); "
          f"design floor {rd_floor_ms:.4f} ms ({RD_CHAIN_CLOCKS} clocks of dependent chain "
          f"per frame, counted, not measured, at {mhz:.0f} MHz)")
    rows.append({"name": "rd_scan", "route": "cuda", "source": "crispy_tpu_torch/csrc/rd_scan.cu",
                 "replaces": "crispy_tpu/dsp/rnnoise/pallas_rnn.py:260", "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None})

    # K3: the pitch-window gather (starts as the pipeline makes them, plus a
    # few out of range to exercise the clamp).
    L = pipeline.HIST + 1 + F * pipeline.FRAME
    ext = torch.from_numpy(rng.standard_normal((S, L)).astype(f32) * 1e3).to(dev)
    pidx = rng.integers(60, 768, (S, F))
    starts_np = 1 + np.arange(F)[None, :] * 480 + (pipeline.PBUF - pipeline.WIN) - pidx
    starts_np[0, 0], starts_np[1, -1] = -L - 50, L  # clamped to 0 and L - 960
    starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
    ga = ok.pitch_window_gather(ext, starts)
    gb = ok.pitch_window_gather_reference(ext, starts)
    torch.cuda.synchronize()
    err = float((ga - gb).abs().max())
    ms = cuda_ms(lambda: ok.pitch_window_gather(ext, starts), 50)
    plain_ms = cuda_ms(lambda: ok.pitch_window_gather_reference(ext, starts), 20)
    idx = (starts.long().clamp(0, L - 960)[..., None]
           + torch.arange(960, device=dev)).contiguous()
    ext_x = ext[:, None, :].expand(S, F, L)
    lib_out = torch.gather(ext_x, 2, idx)
    if not torch.equal(lib_out, gb):
        fail("torch.gather yardstick disagrees with the plain version")
    library_ms = cuda_ms(lambda: torch.gather(ext_x, 2, idx), 20)
    nbytes = ext.numel() * 4 + starts.numel() * 4 + ga.numel() * 4
    b_ms, b_by = bound(nbytes, 0.0)
    print(f"K3 pitch_window_gather: max|kernel-plain|={err:.3e} (exact required) kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.gather {library_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB)")
    if err != 0.0:
        fail(f"K3 is not exact: {err}")
    rows.append({"name": "pitch_window_gather", "route": "cuda",
                 "source": "crispy_tpu_torch/csrc/pitch_gather.cu",
                 "replaces": "crispy_tpu/dsp/rnnoise/pallas_ops.py:68", "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": library_ms})
    return rows + spectra_rows(torch, pipeline, fk, params, dev, rng)


@contextlib.contextmanager
def spectra_path(switch: str):
    """CRISPY_FUSED_SPECTRA=switch ("on": the fused-spectra path, "off": the
    FFT path) inside the block, restored after it."""
    old = os.environ.get("CRISPY_FUSED_SPECTRA")
    os.environ["CRISPY_FUSED_SPECTRA"] = switch
    try:
        yield
    finally:
        if old is None:
            del os.environ["CRISPY_FUSED_SPECTRA"]
        else:
            os.environ["CRISPY_FUSED_SPECTRA"] = old


def pitch_track(torch, pipeline, params, audio: np.ndarray, dev) -> np.ndarray:
    """Pitch indices of every frame, block by block through the frontend."""
    a = torch.from_numpy(audio).to(dev)
    state = pipeline.init_state(a.shape[0], dev)
    blk = F_MAIN * pipeline.FRAME
    n = (a.shape[1] // pipeline.FRAME) * pipeline.FRAME
    out = []
    for d in range(0, n, blk):
        state, fr = pipeline.frontend_block(params, state, a[:, d: min(d + blk, n)])
        out.append(fr["pitch_idx"].cpu().numpy())
    return np.concatenate(out, axis=1)


def main() -> int:
    # The run uses one card: show torch only the first visible one, so the
    # count it reports is the count it used.
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if vis is None else vis.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "crispy_tpu_torch").is_dir():
        print(f"chip_smoke: crispy_tpu_torch not found beside {__file__}", file=sys.stderr)
        return 1
    count = torch.cuda.device_count()
    if count != 1:
        fail(f"expected one visible card, torch sees {count}")
    sys.path.insert(0, str(ROOT))
    from crispy_tpu_torch import _build
    from crispy_tpu_torch.device import resolve_device
    from crispy_tpu_torch.dsp.rnnoise import frontend_kernels as fk
    from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
    from crispy_tpu_torch.dsp.rnnoise import oracle
    from crispy_tpu_torch.dsp.rnnoise import pipeline
    from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
    from crispy_tpu_torch.dsp.rnnoise.weights import builtin_model
    from crispy_tpu_torch.engine import denoiser
    from crispy_tpu_torch.io import wav as wavio

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s -> {lib.name}")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or line.startswith("=="):
                print(f"[1]   {line.strip()}")

    model = builtin_model()
    dev = resolve_device(None)  # the entry points' default: the card
    params = pipeline.make_params(model, dev)

    # --- 2: kernels against their plain versions --------------------------
    with torch.no_grad():
        rows = kernel_phase(torch, pipeline, rk, ok, fk, params, dev)

    # --- 3 and 4: the slice through its entry points, on each spectra path ---
    rng = np.random.default_rng(SEED + 1)
    sr = 48000
    n = sr * SLICE_SECONDS
    stereo = np.stack([speechlike(n, rng, 110.0), speechlike(n, rng, 185.0)], axis=1)
    pcm = (np.clip(stereo, -1.0, 1.0) * 32767.0).astype(np.int16)  # [T, 2]
    audio = pcm.T.astype(np.float32) / 32768.0  # [2, T], the WAV's decoded samples
    # each kernel's launch counter: (wrapper, attribute)
    kernels = {"nn_scan": (rk.nn_scan, "launches"),
               "nn_scan_f32": (rk.nn_scan, "launches_f32"),
               "rd_scan": (rk.rd_scan, "launches"),
               "pitch_window_gather": (ok.pitch_window_gather, "launches"),
               "fwd_spectrum_bands": (fk.fwd_spectrum_bands, "launches"),
               "win_spectrum_bands": (fk.win_spectrum_bands, "launches"),
               "inv_spectrum_ola": (fk.inv_spectrum_ola, "launches")}
    fused_only = ("fwd_spectrum_bands", "win_spectrum_bands", "inv_spectrum_ola")
    never = ("nn_scan_f32",)  # the builtin weights are on the fp16 grid
    n_oracle = ORACLE_SECONDS * sr
    t0 = time.perf_counter()
    oracle_out = np.stack([oracle.denoise_stream(a, model) for a in audio[:, :n_oracle]])
    print(f"[3] the port's NumPy oracle on the first {ORACLE_SECONDS} s of both channels "
          f"({time.perf_counter() - t0:.1f} s)")

    def entry_points(tag: str, tmp: Path, ref_blocks=None):
        """denoise_file and denoise_array on the card, held against the CPU
        path (on the first ref_blocks blocks only, if given: the output up
        to a block boundary depends on nothing after it); returns the f32
        output and the launch counts of this run."""
        src, dst = tmp / "in.wav", tmp / f"out_{tag}.wav"
        for k, attr in kernels.values():
            setattr(k, attr, 0)
        t0 = time.perf_counter()
        info = denoiser.denoise_file(src, dst, model=model)  # default device: the card
        out_f32 = denoiser.denoise_array(audio, model=model, params=params)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        launches = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
        out16, _ = wavio.read_wav(dst)
        out16 = np.round(out16.T * 32768.0).astype(np.int32)  # exact: 16-bit PCM back
        print(f"[{tag}] denoise_file + denoise_array on the card: {info}, {t_gpu:.2f} s; "
              f"launches {launches}")
        n_ref = audio.shape[1] if ref_blocks is None else ref_blocks * F_MAIN * pipeline.FRAME
        t0 = time.perf_counter()
        ref = denoiser.denoise_array(audio[:, :n_ref], model=model, device="cpu")
        t_cpu = time.perf_counter() - t0
        ref16 = (np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int32)
        if out_f32.shape != audio.shape or not np.isfinite(out_f32).all():
            fail(f"bad f32 output: shape {out_f32.shape}, finite {np.isfinite(out_f32).all()}")
        if out16.shape != audio.shape:
            fail(f"bad int16 output shape {out16.shape}")
        f32_err = float(np.abs(out_f32[:, :n_ref] - ref).max())
        i16_err = int(np.abs(out16[:, :n_ref] - ref16).max())
        print(f"[{tag}] vs the port's CPU path on the first {n_ref / sr:.0f} s ({t_cpu:.1f} s): "
              f"f32 max|diff|={f32_err:.3e} "
              f"(tol {F32_TOL}), int16 max|diff|={i16_err} LSB (tol {I16_TOL}); "
              f"output rms {float(np.sqrt(np.mean(out_f32 ** 2))):.4f}, input rms "
              f"{float(np.sqrt(np.mean(audio ** 2))):.4f}")
        if not f32_err <= F32_TOL:
            fail(f"[{tag}] f32 path differs from the CPU path by {f32_err}")
        if not i16_err <= I16_TOL:
            fail(f"[{tag}] int16 path differs from the CPU path by {i16_err} LSB")
        card = denoiser.denoise_array(audio[:, :n_oracle], model=model, params=params)
        o_err = float(np.abs(card - oracle_out).max())
        print(f"[{tag}] denoise_array on the card vs the port's oracle on the first "
              f"{ORACLE_SECONDS} s: f32 max|diff|={o_err:.3e} (tol {F32_TOL})")
        if not o_err <= F32_TOL:
            fail(f"[{tag}] the card differs from the oracle by {o_err}")
        return out_f32, launches

    with tempfile.TemporaryDirectory() as tmp:
        wavio.write_wav(Path(tmp) / "in.wav", pcm, sr)
        with spectra_path("off"):
            out_fft, launches = entry_points("3", Path(tmp))
        for name, c in launches.items():
            if (c > 0) == (name in fused_only or name in never):
                fail(f"kernel {name}: {c} launches on the default path")
        with torch.no_grad():
            p_gpu = pitch_track(torch, pipeline, params, audio, dev)
            p_cpu = pitch_track(torch, pipeline, pipeline.make_params(model, "cpu"), audio,
                                torch.device("cpu"))
        agree = float(np.mean(p_gpu == p_cpu))
        print(f"[3] pitch indices agreeing card vs CPU: {agree:.6f} of {p_gpu.size} "
              f"({int(np.sum(p_gpu != p_cpu))} differ)")

        with spectra_path("on"):
            out_fused, launches_fused = entry_points("4", Path(tmp), ref_blocks=2)
        for name, c in launches_fused.items():
            if (c <= 0) != (name in never):
                fail(f"kernel {name}: {c} launches on the fused-spectra path")
        fft_err = float(np.abs(out_fused - out_fft).max())
        print(f"[4] fused vs the card's FFT path: f32 max|diff|={fft_err:.3e} (tol {F32_TOL})")
        if not fft_err <= F32_TOL:
            fail(f"the fused path differs from the FFT path by {fft_err}")
    for name in fused_only:
        launches[name] = launches_fused[name]

    # --- 5: throughput -----------------------------------------------------
    # THROUGHPUT_BLOCKS blocks per stream (a 10 s speech-like signal repeated),
    # timed THROUGHPUT_RUNS times after a warm-up call; the median is the
    # number, the spread says how far one reading can be trusted.
    base = np.stack([speechlike(2 * F_MAIN * pipeline.FRAME, rng, 80.0 + 2.0 * s)
                     for s in range(S_MAIN)])
    batch = np.tile(base, (1, THROUGHPUT_BLOCKS // 2))
    T = batch.shape[1]
    walls = []
    with spectra_path("off"):
        pipeline.denoise_batch(batch[:, : 2 * F_MAIN * pipeline.FRAME], params=params)  # warm-up
        torch.cuda.synchronize()
        for _ in range(THROUGHPUT_RUNS):
            t0 = time.perf_counter()
            out = pipeline.denoise_batch(batch, params=params)
            walls.append(time.perf_counter() - t0)
            if out.shape != batch.shape or not np.isfinite(out).all():
                fail("bad throughput-phase output")
    xrts = [S_MAIN * T / 48000 / w for w in walls]
    xrt = float(np.median(xrts))
    spread = (max(xrts) - min(xrts)) / xrt
    with torch.no_grad():
        blk = torch.from_numpy(batch[:, : F_MAIN * pipeline.FRAME]).to(dev)
        st = pipeline.init_state(S_MAIN, dev)
        with spectra_path("off"):
            step_ms = cuda_ms(lambda: pipeline.denoise_block(params, st, blk), 5)
        with spectra_path("on"):
            fused_ms = cuda_ms(lambda: pipeline.denoise_block(params, st, blk), 5)
    rt = S_MAIN * F_MAIN * 480 / 48000 * 1e3
    print(f"[5] denoise_batch S={S_MAIN} F={F_MAIN} ({THROUGHPUT_BLOCKS} blocks, "
          f"{T / 48000:.0f} s per stream), {THROUGHPUT_RUNS} runs: wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} s; {xrt:.1f}x realtime at 48 kHz (median; "
          f"runs {', '.join(f'{x:.1f}' for x in xrts)}; spread {100 * spread:.1f}%); "
          f"block step on the card: FFT path {step_ms:.3f} ms = {rt / step_ms:.1f}x realtime, "
          f"fused-spectra path {fused_ms:.3f} ms = {rt / fused_ms:.1f}x realtime [{card}]")

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
