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
     (torch.profiler) beside its design floor; then K1 (resident), K2, K3
     and K4-K6 at the monitoring shape, S=1, F=1, at the same tolerances,
     timed by CUDA events and by torch.profiler;
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
     of each spectra path by CUDA events;
  6. whisper-base (random weights from seed 0, written as an f16 ggml file
     by the port's ``write_ggml`` and loaded by ``load_ggml``) on the card
     against the port's CPU path on two 30 s speech-like 16 kHz chunks: the
     log-mel, the encoder, teacher-forced and prefill logits with an f32 KV
     cache, the card's cached greedy tokens against the argmax of its own
     teacher-forced logits along them, and the share of greedy tokens the
     card and the CPU agree on with the default bf16 cache; then the
     engine's decode, ``sample_decode`` at T=0 over a 16-chunk bucket with
     the default cache, on the card against the CPU: equal tokens and
     lengths, its log-prob sums and no-speech probabilities within 1e-4;
  7. decode throughput: ``greedy_decode`` at B=8 and B=16 over 30 s chunks,
     224 tokens with no eot (the worst case), median of 3 calls: RTF, mel
     plus encoder ms per batch, and a ``torch.profiler`` top 10 and the
     device-busy share of one decode call;
  8. end to end: a 5 min 48 kHz 16-bit mono WAV through ``run_transcription``
     and ``load_engine`` (the phase-6 file under a stub model manager):
     status, sidecar, progress, every chunk batch on the card, wall time,
     RTF and the ``stage-timing`` events (host clock; the ``resample``
     stage times the upload and the launch only, so the resampler's own
     upload plus conv is timed again by CUDA events).

  9. live monitoring and recording: (a) ``GraphedBlockStep`` (the block
     step at S=1, F=1 replayed from a CUDA graph) on each spectra path over
     400 frames, bit-equal to the eager step on the card and within 1.5e-4
     of the oracle on every frame whose pitch index is the oracle's (a
     pitch index at a near-tie, and the frame after it, are counted and
     printed); (b) the main path: ``MonitoringEngine`` (realtime off) on a
     30 s 48 kHz device, its ``mic_tap`` feeding a recording started by
     ``do_start_recording`` with a ``FileSource`` app track, the WAV held
     to a host replay of the mix from the logged ring operations, the
     monitor's output and the app track (48 kHz stereo s16, L == R, within
     1 LSB), K1-K3 launched once a frame; (c) ``push_block``'s per-frame
     latency through the graph over 1,000 frames, failing if its median
     exceeds the 10 ms frame budget, and the eager step's for the record;
     (d) the same while ``denoise_batch`` at S=128, F=500 runs in another
     thread (printed only); (e) a ``torch.profiler`` trace of 20 replays
     showing K1 (resident), K2 and K3 once each, the kernels and device time
     a frame; (f) the ``resample`` command on a 44.1 kHz WAV and config 2 on
     the card (10 min of 44.1 kHz to 48 kHz, added to a 48 kHz track, dual
     mono) by CUDA events (printed only).

 10. the native ASR families, from prepared bundles (``params.npz`` from the
     port's ``init_random`` at seed 0, ``config.json``, a ``tokenizer.model``
     from ``build_model_bytes``) in a temporary model directory: (a)
     parakeet-tdt-0.6b at its published widths through ``load_engine`` on
     the card, held against the port's CPU path on one 30 s chunk (NeMo
     features within 1e-4 of their max, the count of frames whose valid bit
     differs, the encoder output within 1e-3 of its max, the TDT decisions
     step by step), then B=8 chunks: the frontend, encoder and decode loop
     by CUDA events, the loop's iterations, its launches per iteration and
     the device's busy share (torch.profiler), the engine's RTF; (b) a 5 min
     48 kHz WAV through ``run_transcription`` and that engine, with text for
     every chunk; (c) gigaam (the JAX package's bundle-test widths),
     canary-180m-flash, moonshine-base and sense-voice-small, each on the
     card against the CPU path on two of its B=8 chunks (every CTC frame's
     argmax, the greedy tokens, the texts) and its RTF, and for canary and
     moonshine the launches a decode step and the device's busy share in
     their greedy loops (torch.profiler). A decision that
     differs card vs CPU passes only at a near-tie (the CPU's top-two margin
     below 1e-4 of the step's largest |logit|); each is printed and counted.

 11. speaker diarization: (a) ``synth_speaker_hour(60)`` (57.6 M samples,
     3 tone speakers) through ``diarize(max_speakers=8, merge_gap=1.0)``
     with the built-in nets on the card (the one-upload route: 366 windows,
     900 chunks, NME-SC at N=1024, P=64), 3 timed calls (median, spread,
     ×realtime, peak memory), the stages of one more by CUDA events
     (upload and quantize, margins, chunk statistics, the NME sweep, the
     final eigensolve with k-means), held against the port's CPU path on
     the same hour (equal speaker segments; energy margins within 1e-4 of
     0 counted), then a 60 s clip on the host-VAD route, equal to the CPU
     path's; (b) PyanNet segmentation-3.0 and CAM++ wespeaker-voxceleb at
     their published widths (the JAX layout's ``init_random`` at seed 0
     through the carry), card against CPU within 1e-4 of their max
     (logits of 2 windows; embeddings of 16 chunks on the same fbank
     features, beside the difference from each device's own features),
     the first 150 s through the ``from_device`` route equal to the CPU
     path's, then the hour composed as the JAX package's bench composes
     it (net outputs at weight 0, decisions from the energy margins; a
     non-finite net output fails), 3 timed calls with the nets' forwards
     and NME-SC by CUDA events; (c) the phase-8 WAV through
     ``run_transcription(diarization={"enabled": True})`` and the phase-6
     Whisper file: completed, no ``diarization-fallback`` event, speaker
     tags in the text, its speaker segments equal to a separate
     ``diarize`` of the same 16 kHz audio on the card.

 12. the ONNX executor: (a) parakeet-tdt-0.6b-v3 as an int8 ONNX bundle at
     its published widths (``tools/bench_bundles.make_parakeet_sized_bundle``,
     random weights from seed 0, no params.npz) through ``load_engine`` on
     the card, which must give the port's ``OnnxTdtEngine``: B=8 and B=16 x
     30 s, a warm-up then 3 calls (RTF, median), the encoder by CUDA events
     (one call under CUDA's sync debug mode ``error``: no host sync),
     executor nodes a call, one encoder call and one decode loop under
     torch.profiler (launches, device busy share), peak memory, the seconds
     to build and load the bundle; (b) the same bundle on the card against
     the CPU on 2 x 10 s: the first layer's DynamicQuantizeLinear codes (how
     many differ), its MatMulInteger on the CPU's codes (bit-equal), the
     encoder output within 5e-2 of its max, every token and duration
     decision of the decode loop on the card's encoder output equal off
     near-ties (a CPU top-two margin below 1e-2 of the step's largest
     |logit|, counted); (c) the phase-8 WAV through ``run_transcription`` and
     that engine: ten chunks in one 16-bucket on the card, wall and RTF;
     (d) the gigaam and sensevoice CTC layouts and the small parakeet TDT
     layout of the JAX package's engine tests through ``load_engine``, card
     against CPU (equal texts and word segments), and one ConvInteger graph
     and one Loop graph with a condition computed on the card (equal
     outputs).

 13. the ONNX enc-dec bundles and the executor's diarization nets: (a)
     canary-180m-flash as an int8 ONNX bundle at its published widths (the
     port's models/canary config: tools/bench_bundles' FastConformer
     encoder, 17 layers, d 512, and ``canary_decoder``, 4 pre-LN layers, d
     512, V 5248, eos's logit column zero so every row decodes to max_new
     unless the loop guard ends it; random weights from seed 0, no
     params.npz) through ``load_engine``, which must give the port's
     ``OnnxEncDecEngine``: B=8 and B=16 x 30 s, a warm-up then 1 timed call
     (RTF), decode steps by bucket, tokens per row, the encoder by
     CUDA events, executor nodes a step, launches a step and the device's
     busy share over 8 decode steps (torch.profiler), peak memory; then on 2
     x 10 s the encoder card vs CPU (5e-2 of its max) and greedy and beam-4
     decoding (48 tokens) of the card's encoder output on both devices,
     every decision equal up to the first that differs, which must be a
     near-tie (1e-2 of the largest |logit| or |score|), counted; (b)
     pyannote-sized segmentation and CAM++-scale embedding graphs
     (tools/bench_bundles) through ``models/onnx_nets``: card vs CPU (logits
     of 2 windows, embeddings of 16 speech-like chunks, 1e-4 of their max),
     the diarization hour composed as the JAX package's executor bench
     composes it (outputs at weight 0; a non-finite output fails), 3 timed
     calls with the graphs, the executor's LSTM and NME-SC by CUDA events,
     and ``run_diarization`` on 150 s under a stub manager holding both
     files: the executor route, no ``diarization-fallback``; (c) the hour
     drill of tests/test_torch_hour_scale.py on the card in a process of
     its own, started at the smoke's start so that its peak RSS is its own
     (cancel past 10%, resume, diarization, sidecar; wall, peak RSS and
     device memory); (d) the canary, moonshine-preprocess, merged-
     decoder and cohere enc-dec layouts of the JAX package's engine tests
     through ``load_engine``, card vs CPU (equal texts and word segments).

 14. RNNoise training (``dsp/rnnoise/training.py``, ``parallel/train.py``) at
     the training tool's defaults, B=32 streams x F=100 frames, the builtin
     net's widths (87,503 weights): (a) ``make_batch`` from seed 0 on the
     card against the port's CPU path on the same draws (features on frames
     with equal pitch index, gains on bands above digital silence, the mask,
     pitch indices that differ counted); (b) the masked loss and its
     gradients at train_model's init on that batch, card vs CPU; (c)
     ``train_model`` in corpus mode, 256 corpus streams, 50 steps, 25 a
     call: each call's wall, ms a step, peak memory, the loss curve (finite,
     falling), K2 and K3 once a step and no other kernel, then one more
     step under torch.profiler (launches a step, the device's busy share);
     (d) five host-mode steps with ``synth_batch``'s share; (e) the held-out
     SNR gain of the packaged model, card vs CPU (K1-K3 launched), and of
     the 50-step model; (f) ``python -m crispy_tpu_torch.tools.train_rnnoise
     --steps 25 --corpus-streams 64`` in a process of its own (the saved
     model must load), then ``cli models list`` and ``cli update`` (the
     index a local stand-in).

 15. a served session: ``WebServer`` over ``CrispyApp(bus=EventBus(),
     data_root=<temp dir>)`` on loopback in this process, driven only over
     HTTP as the page drives it: (a) the four pages byte-equal to the
     port's ``webui`` files, and the refusals (foreign Host 403, foreign
     Origin 403, /api without JSON 415, an unknown command 404, bad kwargs
     400); (b) whisper-small at its published widths (random weights from
     seed 0, written by ``write_ggml`` as the catalog's ``ggml-small.bin``)
     selected with ``set_active_model``, diarization on by
     ``set_app_setting``; (c) an ``/events`` client on its own thread,
     ``start_monitoring`` (rnnoise) on a registered speech-like device, a
     recording of 30 s of the device's audio held at 0 LSB to a host replay
     of the logged ring operations, listed by ``get_recordings`` and read
     back through ``/stream`` whole and by three Range requests, byte-equal;
     ``microphone-level`` and ``stage-timing`` events received, the loop's
     pacing of the device at least 0.99x realtime; (d) the
     phase-8 WAV through ``/upload``, then both files through
     ``start_transcription`` while monitoring runs, monitoring restarted
     during the upload's decode (a graph captured in a request thread while
     the transcription thread launches work), the SSE progress fed into
     ``TranscriptionProgressTracker`` (to 100%, never backwards), each
     served transcript equal to ``run_transcription`` called directly on
     the card, text and ``[Speaker N|start]`` tags; (e) ``push_block``'s
     per-frame latency in the monitoring loop over the transcription window
     (the median gated at 10 ms; p99, max, late frames and the UI's
     ``stage-timing`` printed); (f) K1-K3's launches risen, K4-K6's and the
     f32 K1's at zero, no thread of the session left but the SSE handlers,
     peak device memory; (g) ``python -m crispy_tpu_torch.cli serve --port
     0`` in a process of its own: its JSON line, ``GET /``,
     ``/api/get_platform``, exit 0 after Ctrl-C.

 16. one process over a list of devices, the mesh made of entries of the
     one card (``parallel.make_mesh(devices=["cuda:0"] * n)``; every wall
     time printed beside the unsharded call's is that of repeated entries
     of one card, not a multi-GPU speed-up): (a) ``denoise_batch`` at
     S=128 x F=500, 4 blocks a stream, on both spectra paths, unsharded and
     over dp=2 and dp=3 (S pads to 129), held to the unsharded output at
     1.5e-4, pitch indices that differ counted, K1-K3's launches (and
     K4-K6's on the fused path) exactly dp x blocks; (b) whisper-base (the
     phase-6 file) through ``TranscriptionManager(mesh=(2, 2))`` and
     ``run_transcription`` of the phase-8 WAV, its text equal to phase 8's,
     teacher-forced logits of one B=8 batch within 1e-4 of the unsharded
     model's, and the (2, 2) placement's device memory beside the model's
     (repeated entries share one copy); (c) the phase-12a 0.6b int8 bundle,
     B=8 x 30 s, through ``load_engine(mesh=...)`` at dp=2 and dp=3:
     transcripts equal to the unsharded engine's, every
     DynamicQuantizeLinear scale of the encoder within 1e-5 of the
     unsharded one on each shard; (d) the phase-11 hour over dp=2: the
     built-in route's segments, margins and chunk statistics bit-equal and
     NME-SC labels equal,
     and the PyanNet + CAM++ ``from_device`` route (staged, [11b]'s nets)
     with equal speakers; (e) ``CrispyApp``: no mesh with ``CRISPY_MESH``
     unset on one card, and over ``make_mesh(["cuda:0"] * 2)``
     ``start_transcription`` with diarization of the phase-8 WAV equal to
     the unsharded app's.

 17. training over a mesh and several processes on the one card (repeated
     entries of it; one card shows correctness, not a speed-up): (a)
     ``make_train_step`` over (2, 1) and (2, 2) against the unsharded step,
     5 masked steps at B=32 x F=100 from train_model's init draw: losses
     within 1e-5 relative, parameters within 1e-5 of each tensor's largest
     |value|, the replicas bit-equal; (b) [14c]'s ``train_model`` call over
     dp=2 against [14c]'s loss curve (1e-4 relative), K2 and K3 twice a
     step; (c) two processes started by ``multihost.launch_local`` (each
     runs this file with ``--rank17c``) share the card under gloo: each
     feeds its half of a global S=128 x F=500 denoise batch through
     ``denoise_batch(mesh=mesh.local)``, of a B=8 whisper-base batch (the
     phase-6 file, 30 s mel, 8 new tokens) through a greedy decode over
     ``mesh.local``, and runs (a)'s 5 DP steps over the process mesh; here
     its rows are held to the one-process ``denoise_batch`` (1.5e-4), its
     tokens to the one-process decode (equal), its losses and parameters
     to (a)'s unsharded run at (a)'s tolerances and to rank 0's (bit-equal);
     each rank launched K1-K3 once. The ranks run while (a) and (b) run
     here: their host walls are printed beside the one-process walls, not
     as speed-ups.

The Whisper, ASR, diarization and ONNX phases run no hand-written kernel
(the JAX package's models and executor have no Pallas kernel), so they add
no row to the kernels line. The training net's backward is autograd in
plain PyTorch (K1 is forward-only, and the JAX package trains through a
plain scan); phase 14 runs K2 and K3 in its targets.

Then one JSON line with every kernel's numbers (launches from phases 3, 4,
9b, 14c, 15, 16a, 17b and 17c's ranks), and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``crispy_tpu``.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

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

WHISPER = "base"  # whisper-base at its published widths (d=512, 8 heads, 6+6 layers)
MEL_TOL = 1e-4  # log-mel, absolute: f32 FFTs (cuFFT vs pocketfft) in another order
ENC_RTOL = 1e-4  # encoder output, x its max: f32 products in another order
LOGIT_RTOL = 1e-4  # teacher-forced and prefill logits (f32 KV), x their max
LP_RTOL = 1e-4  # sample_decode's sum of log-probs per chunk, relative
NS_TOL = 1e-4  # sample_decode's no-speech probability, absolute
SAMPLE_BATCH = 16  # run_transcription's chunk bucket
DECODE_NEW = 224  # tokens per chunk in phases 6 and 7
DECODE_BATCHES = (8, 16)
DECODE_RUNS = 3
E2E_SECONDS = 300  # the phase-8 WAV: 10 chunks, one 16-chunk bucket

MON_FRAMES = 400  # phase 9a: frames through the graphed and the eager step, each path
MON_SECONDS = 30  # phase 9b: the monitored device's length
LAT_FRAMES = 1000  # phase 9c, 9d: frames timed through push_block
EAGER_FRAMES = 60  # phase 9c: frames through the eager step (the first 5 not counted)
PROFILE_FRAMES = 20  # phase 9e: replays under torch.profiler
CFG2_SECONDS = 600  # phase 9f: config 2's 10 min of 44.1 kHz

ASR_BATCH = 8  # phase 10: 30 s chunks a batch on the card
ASR_SECONDS = 30
ASR_E2E_SECONDS = 300  # phase 10b's WAV: 10 chunks
FEAT_RTOL = 1e-4  # NeMo features card vs CPU, x their max: cuFFT against pocketfft
PK_ENC_RTOL = 1e-3  # the 24-layer encoder's output card vs CPU, x its max
TIE_RTOL = 1e-4  # a divergent decision passes below this top-two margin, x max|logit|
PROFILE_STEPS = 32  # phase 10c: new tokens in the profiled canary and moonshine loops

DIAR_MINUTES = 60  # phase 11: synth_speaker_hour's hour, 57.6 M samples at 16 kHz
DIAR_RUNS = 3  # timed diarize calls a cell (median and spread)
DIAR_CLIP_SECONDS = 60  # phase 11a: the host-VAD route
STAGED_CHECK_SECONDS = 150  # phase 11b: card vs CPU on the from_device route
NET_RTOL = 1e-4  # PyanNet logits and CAM++ embeddings card vs CPU, x their max
MARGIN_TIE = 1e-4  # an energy margin this near 0 may decide speech differently card vs CPU

ONNX_DIMS: dict = {}  # phase 12: bench_bundles' defaults, parakeet-tdt-0.6b-v3's published widths
ONNX_CHECK_SECONDS = 10  # phase 12b: B=2 chunks of this length, card vs CPU
# phase 12b, the int8 encoder's output card vs CPU, x its max: a 1e-6 difference
# in an activation flips uint8 codes at their rounding boundaries, and each flip
# moves a whole row of the next product by one quantum
ENC_INT8_RTOL = 5e-2
# phase 12b: a divergent TDT decision passes below this top-two margin, x
# max|logit|: a code flipped in the joint's own quantized products moves its
# logits by about one activation quantum times the weight scale
INT8_TIE_RTOL = 1e-2

ENCDEC_BATCHES = (8, 16)  # phase 13a: 30 s chunks a batch through the canary ONNX bundle
ENCDEC_RUNS = 1  # phase 13a: timed calls a bucket (2 until PR 17 cut it for [17])
ENCDEC_CHECK_NEW = 48  # phase 13a: tokens a row in the card-vs-CPU decodes (2 x 10 s)
ENCDEC_PROFILE_STEPS = 8  # phase 13a: decode steps under torch.profiler (its trace of
#   ~2,300 launches a step takes seconds a step to read back)
ENCDEC_BEAM = 4
EXEC_EMB_CHUNKS = 16  # phase 13b: embeddings card vs CPU
DRILL_TIMEOUT = 900  # phase 13c: seconds for the hour drill's process

TRAIN_B, TRAIN_F = 32, 100  # phase 14: the training tool's defaults, the builtin net's widths
TRAIN_CORPUS = 256  # phase 14c: corpus streams on the card
TRAIN_STEPS, TRAIN_SPC = 50, 25  # phase 14c (and 17b over dp=2): steps, steps a call
TRAIN_PROFILE_STEPS = 1  # phase 14c: steps under torch.profiler (~20,600 launches a step to read back)
TRAIN_HOST_STEPS = 5  # phase 14d
TOOL_STEPS, TOOL_CORPUS = 25, 64  # phase 14f: the training tool in a process of its own
# phase 14a, make_batch card vs CPU. Both run the port's f32 HP biquad (a
# Toeplitz product and a carry scan: cuBLAS against MKL), whose rounding is
# ~10 at the x32768 scale on strong low-frequency noise; a quiet band's
# energy carries it relative to its size, and log10 carries that into the
# cepstra. Gated on the distribution among frames with equal pitch index:
# the median frame's largest difference and every frame's. Set from this
# batch's own readings on the H100 (seed 0, the same in every run so far):
# median frame 6.819e-05, largest 4.921e-02.
BATCH_FEAT_MEDIAN_TOL, BATCH_FEAT_MAX_TOL = 2e-4, 7.5e-2
# gains on bands above digital silence (noisy Ex >= 1 at the x32768 scale),
# absolute: the 99.9th percentile and the largest (readings 2.107e-03, 1.084e-02)
BATCH_GAIN_Q_TOL, BATCH_GAIN_MAX_TOL = 5e-3, 2e-2
TRAIN_LOSS_RTOL = 1e-5  # phase 14b: the loss card vs CPU, relative (f32 vs f64 on the CPU: 5e-8)
TRAIN_GRAD_RTOL = 1e-4  # phase 14b: x each tensor's largest |g| (f32 vs f64 on the CPU: 3.4e-7)
# phase 14e, dB: the packaged model's held-out SNR gain card vs CPU, both the
# port (reading 3e-4 dB; the port against the JAX package, whose HP stages
# really differ, is held at 0.05 dB in tests/test_torch_training.py)
SNR_CARD_TOL = 5e-3
SERVE_WHISPER = "small"  # phase 15: the catalog's whisper-small at its published widths
SERVE_RECORD_SECONDS = 30  # phase 15c: the recording's length
SERVE_LOOP_SECONDS = 60  # phase 15: the monitored device's audio, looped
MON_PACE_MIN = 0.99  # phase 15c: the monitoring loop's pacing of the device, x realtime
PROBE_LAUNCHES = 5000  # launch-rate probe: in-place adds on one element, host clock
STEP_PROBE_STEPS = 5  # training-step probe at phase 1 and [14c]


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


@contextlib.contextmanager
def kv_cache(dtype: str):
    """CRISPY_WHISPER_KV=dtype inside the block, restored after it."""
    old = os.environ.get("CRISPY_WHISPER_KV")
    os.environ["CRISPY_WHISPER_KV"] = dtype
    try:
        yield
    finally:
        if old is None:
            del os.environ["CRISPY_WHISPER_KV"]
        else:
            os.environ["CRISPY_WHISPER_KV"] = old


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, both brought to the host."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def whisper_phase(torch, dev, tmp: Path, rng) -> Path:
    """Phase 6: whisper-base on the card against the port's CPU path."""
    from crispy_tpu_torch.dsp.mel import log_mel_spectrogram
    from crispy_tpu_torch.models.whisper import CONFIGS, WhisperModel
    from crispy_tpu_torch.models.whisper import model as wm
    from crispy_tpu_torch.models.whisper.ggml_io import write_ggml
    from crispy_tpu_torch.models.whisper.weights import init_random

    cfg = CONFIGS[WHISPER]
    t0 = time.perf_counter()
    path = write_ggml(tmp / f"ggml-{WHISPER}-random.bin", init_random(cfg, seed=0), cfg, ttype=1)
    card = WhisperModel.from_ggml(path)  # default device: the card
    cpu = WhisperModel.from_ggml(path, device="cpu")
    n_params = sum(p.numel() for p in card.model.parameters())
    print(f"[6] whisper-{WHISPER}: {n_params / 1e6:.1f} M random weights (seed 0) through an "
          f"f16 ggml file ({path.stat().st_size / 1e6:.1f} MB), loaded on {card.device} and cpu "
          f"in {time.perf_counter() - t0:.1f} s")
    audio = torch.from_numpy(np.stack([speechlike(480000, rng, f0, sr=16000)
                                       for f0 in (120.0, 210.0)]))
    with torch.no_grad():
        mel_c = log_mel_spectrogram(audio.to(dev), cfg.n_mels, pad_to_chunk=True)
        mel_h = log_mel_spectrogram(audio, cfg.n_mels, pad_to_chunk=True)
        mel_err = float((mel_c.cpu() - mel_h).abs().max())
        enc_c = wm.encode(card.model, mel_c)
        enc_h = wm.encode(cpu.model, mel_h)
        enc_err = rel_err(enc_c, enc_h)
        tok = card.tokenizer
        prompt_ids = tok.sot_sequence("en")
        seq = torch.tensor([prompt_ids + list(np.random.default_rng(SEED).integers(0, tok.eot, 60))]
                           * 2)
        with kv_cache("f32"):
            tf_err = rel_err(wm.decode_logits(card.model, seq.to(dev), enc_c),
                             wm.decode_logits(cpu.model, seq, enc_h))
            L = seq.shape[1]
            pre_c = wm._prefill(card.model, seq.to(dev), *wm._init_cache(card.model, enc_c, L))[0]
            pre_h = wm._prefill(cpu.model, seq, *wm._init_cache(cpu.model, enc_h, L))[0]
            pre_err = rel_err(pre_c, pre_h)
            prompt = seq[:, : len(prompt_ids)].to(dev)
            toks, lens = wm.greedy_decode(card.model, enc_c, prompt, max_new=DECODE_NEW)
            full = torch.cat([prompt, toks], dim=1)
            tf = wm.decode_logits(card.model, full[:, :-1], enc_c)[:, len(prompt_ids) - 1:]
            picked = tf.gather(-1, toks[..., None])[..., 0]
            live = torch.arange(toks.shape[1], device=dev)[None] <= lens[:, None]
            # a cached token may differ from the teacher-forced argmax only at a
            # near-tie within the logits tolerance
            off = ((picked < tf.amax(-1) - LOGIT_RTOL * float(tf.abs().max())) & live)
            n_off, n_live = int(off.sum()), int(live.sum())
        g_card, _ = wm.greedy_decode(card.model, enc_c, prompt, max_new=DECODE_NEW)
        g_cpu, _ = wm.greedy_decode(cpu.model, enc_h, prompt.cpu(), max_new=DECODE_NEW)
        same = (g_card.cpu() == g_cpu)
        first_diff = [int(row.logical_not().nonzero()[0]) if not row.all() else DECODE_NEW
                      for row in same]
        # the engine's decode (transcribe_chunks_robust's first rung): T=0
        # over a full bucket, default KV cache, its quality metrics compared
        a16 = torch.from_numpy(np.stack([speechlike(480000, rng, 90.0 + 11.0 * b, sr=16000)
                                         for b in range(SAMPLE_BATCH)]))
        p16 = torch.tensor([prompt_ids] * SAMPLE_BATCH)
        ns_id = min(tok.no_speech, cfg.n_vocab - 1)
        sot_index = prompt_ids.index(tok.sot)

        def engine_decode(model, d):
            mel = log_mel_spectrogram(a16.to(d), cfg.n_mels, pad_to_chunk=True)
            gen = torch.Generator(device=d).manual_seed(0)
            out = wm.sample_decode(model, mel, p16.to(d), 0.0, gen, ns_id, sot_index,
                                   max_new=DECODE_NEW, eot=tok.eot)
            return [t.cpu() for t in out]

        s_toks, s_lens, s_lp, s_ns = engine_decode(card.model, dev)
        h_toks, h_lens, h_lp, h_ns = engine_decode(cpu.model, torch.device("cpu"))
        s_rows = int((s_toks == h_toks).all(1).sum())
        lp_err = float(((s_lp - h_lp).abs() / h_lp.abs()).max())
        ns_err = float((s_ns - h_ns).abs().max())
    print(f"[6] card vs CPU: log-mel max|diff| {mel_err:.3e} (tol {MEL_TOL}); encoder "
          f"{enc_err:.3e} of its max (tol {ENC_RTOL}); with an f32 KV cache, teacher-forced "
          f"logits {tf_err:.3e} and prefill logits {pre_err:.3e} of their max on {L} tokens "
          f"(tol {LOGIT_RTOL}); the card's cached greedy tokens (f32 KV) off the argmax of its "
          f"own teacher-forced logits: {n_off} of {n_live}")
    print(f"[6] default bf16 KV cache: greedy tokens agreeing card vs CPU {float(same.float().mean()):.4f} "
          f"of {same.numel()} (first difference per chunk at token {first_diff})")
    print(f"[6] sample_decode T=0, B={SAMPLE_BATCH}, default KV cache, card vs CPU: {s_rows} of "
          f"{SAMPLE_BATCH} token rows equal, lengths {'equal' if torch.equal(s_lens, h_lens) else 'differ'} "
          f"({s_lens.tolist()}); lp_sum {lp_err:.3e} relative (tol {LP_RTOL}), no_speech_prob "
          f"{ns_err:.3e} (tol {NS_TOL})")
    if not mel_err <= MEL_TOL:
        fail(f"log-mel differs from the CPU path by {mel_err}")
    if not enc_err <= ENC_RTOL:
        fail(f"encoder differs from the CPU path by {enc_err} of its max")
    if not (tf_err <= LOGIT_RTOL and pre_err <= LOGIT_RTOL):
        fail(f"logits differ from the CPU path: teacher-forced {tf_err}, prefill {pre_err}")
    if n_off:
        fail(f"{n_off} cached greedy tokens are not the teacher-forced argmax")
    if s_rows != SAMPLE_BATCH or not torch.equal(s_lens, h_lens):
        fail(f"sample_decode's tokens differ from the CPU path in {SAMPLE_BATCH - s_rows} rows")
    if not (lp_err <= LP_RTOL and ns_err <= NS_TOL):
        fail(f"sample_decode's lp_sum ({lp_err}) or no_speech_prob ({ns_err}) differ from the CPU")
    return path


def decode_phase(torch, dev, path: Path, rng, card: str) -> dict:
    """Phase 7: greedy decode throughput at B=8 and B=16, and one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    from crispy_tpu_torch.dsp.mel import log_mel_spectrogram
    from crispy_tpu_torch.models.whisper import WhisperModel
    from crispy_tpu_torch.models.whisper import model as wm

    m = WhisperModel.from_ggml(path)
    cfg = m.cfg
    out = {}
    for B in DECODE_BATCHES:
        audio = torch.from_numpy(
            np.stack([speechlike(480000, rng, 100.0 + 7.0 * b, sr=16000) for b in range(B)])).to(dev)
        prompt = torch.tensor([[cfg.sot, cfg.sot + 1, cfg.sot + 2]] * B, device=dev)

        def front():
            return wm.encode(m.model, log_mel_spectrogram(audio, cfg.n_mels, pad_to_chunk=True))

        def decode():
            mel = log_mel_spectrogram(audio, cfg.n_mels, pad_to_chunk=True)
            toks, _ = wm.greedy_decode(m.model, mel, prompt, max_new=DECODE_NEW, eot=-1)
            return toks

        with torch.no_grad():
            front_ms = cuda_ms(front, 3, 1)
            toks = decode()  # warm-up
            torch.cuda.synchronize()
            if toks.shape != (B, DECODE_NEW):
                fail(f"greedy_decode gave tokens of shape {tuple(toks.shape)}")
            walls = []
            for _ in range(DECODE_RUNS):
                t0 = time.perf_counter()
                decode()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        out[B] = {"rtf": wall / (B * 30.0), "wall_s": walls, "front_ms": front_ms}
        print(f"[7] greedy_decode B={B}, {DECODE_NEW} tokens, no eot: wall "
              f"{', '.join(f'{w:.3f}' for w in walls)} s; RTF {wall / (B * 30.0):.3e} "
              f"(median; wall seconds per audio second); mel + encoder {front_ms:.2f} ms per "
              f"batch (CUDA events) [{card}]")
    # one decode call at the larger batch under the profiler, device
    # activity only: host events of ~55k launches take a minute to aggregate
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
    launches = sum(e.count for e in kernels)
    print(f"[7] profile of one decode call at B={DECODE_BATCHES[-1]}: wall {wall_ms:.1f} ms "
          f"(under the profiler), device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}%, "
          f"{launches} kernel launches; top 10 by device time:")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"[7]   {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} calls  {e.key[:90]}")
    out["busy_share"] = busy_ms / wall_ms
    return out


def e2e_phase(torch, dev, path: Path, tmp: Path, rng, card: str):
    """Phase 8: run_transcription through load_engine on a 5 min 48 kHz WAV;
    returns the WAV and its model manager (phases 11c and 16b read them),
    the text and the wall time."""
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.dsp.resample import resample_poly
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.io import wav as wavio
    from crispy_tpu_torch.models.registry import ModelInfo

    class StubManager:
        """The catalog has no whisper-base: this id points at the phase-6 file."""
        info = ModelInfo(f"whisper-{WHISPER}-random", f"Whisper {WHISPER} (random weights)",
                         "", path.name, None, 0, "whisper", 0.0, 0.0)

        def find(self, model_id):
            return self.info if model_id == self.info.id else None

        def model_path(self, model_id):
            return path

        def is_downloaded(self, model_id):
            return model_id == self.info.id

    sr = 48000
    n = E2E_SECONDS * sr
    pcm = (np.clip(speechlike(n, rng, 140.0, sr=sr), -1.0, 1.0) * 32767.0).astype(np.int16)
    wav = wavio.write_wav(tmp / "talk.wav", pcm, sr)
    bus = EventBus()
    bus.keep_history = True
    seen = []

    def loader(model_id, mm):
        engine = tr.load_engine(model_id, mm)  # default device: the card
        inner = engine.transcribe_batch

        def recording(chunks, language="en"):
            seen.append((type(chunks).__name__, str(getattr(chunks, "device", "host")),
                         tuple(chunks.shape)))
            return inner(chunks, language=language)

        engine.transcribe_batch = recording
        return engine

    tm = tr.TranscriptionManager(StubManager(), bus=bus, engine_loader=loader)
    t0 = time.perf_counter()
    text = tr.run_transcription(str(wav), tm, StubManager.info.id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = tm.get_state(str(wav))
    progress = [p["progress"] for e, p in bus.history if e == "transcription-progress"]
    stages = [(p["stage"], round(p["seconds"], 4), {k: v for k, v in p.items()
                                                     if k not in ("stage", "seconds")})
              for e, p in bus.history if e == "stage-timing"]
    print(f"[8] run_transcription of a {E2E_SECONDS} s 48 kHz 16-bit WAV through load_engine: "
          f"status {st.status if st else None}, wall {wall:.3f} s, RTF {wall / E2E_SECONDS:.3e} "
          f"(model load included), chunk batches {seen}, progress {progress}, "
          f"{len(text)} characters [{card}]")
    print(f"[8] stage-timing events (host clock): {stages}")
    audio, _ = wavio.read_wav_mono(wav)
    rs_ms = cuda_ms(lambda: resample_poly(audio, sr, 16000, wire="i16", device_out=True), 3, 1)
    print(f"[8] resampler {sr} -> 16000 Hz of the {E2E_SECONDS} s WAV, int16 upload plus conv: "
          f"{rs_ms:.3f} ms (CUDA events, mean of 3) [{card}]")
    if st is None or st.status != "completed":
        fail(f"run_transcription ended in {st}")
    if tr.load_transcription_result(str(wav)) != text or not text:
        fail("the sidecar does not hold the returned text")
    if not progress or progress[-1] != 1.0:
        fail(f"progress did not reach 1.0: {progress}")
    if not seen or any(kind != "Tensor" or not d.startswith("cuda") for kind, d, _ in seen):
        fail(f"a chunk batch was not a tensor on the card: {seen}")
    return wav, StubManager(), text, wall


def monitoring_shape_lines(torch, pipeline, rk, ok, fk, params, dev, rng) -> None:
    """Phase 2 at the monitoring shape, one stream and one frame a step
    (S=1, F=1): K1 (resident), K2, K3 and K4-K6 (as the fused monitoring
    path runs them) against their plain versions at the tolerances above,
    timed by CUDA events over back-to-back calls (host launch cost
    included) and by torch.profiler (the kernel's own time)."""
    from crispy_tpu_torch.dsp.rnnoise import rd_rows

    S, F = 1, 1
    f32 = np.float32
    feats = torch.from_numpy(rng.standard_normal((S, F, 42)).astype(f32)).to(dev)
    silence = torch.zeros((S, F), dtype=torch.bool, device=dev)
    state = pipeline.init_state(S, dev)
    for k in ("gru_vad", "gru_noise", "gru_denoise", "lastg"):
        state[k] = torch.from_numpy(rng.random(tuple(state[k].shape)).astype(f32)).to(dev)
    (a1, a2, a3), sa = rk.nn_scan(params, state, feats, silence)
    (b1, b2, b3), sb = rk.nn_scan_reference(params, state, feats, silence)
    torch.cuda.synchronize()
    k1_err = max(float((x - y).abs().max()) for x, y in
                 [(a1, b1), (a2, b2), (a3, b3)] + [(sa[k], sb[k]) for k in sa])
    rows = {}
    for kind in ("random", "continuation"):
        rows[kind] = tuple(torch.from_numpy(x).to(dev)
                           for x in getattr(rd_rows, f"{kind}_rows")(rng, S, F))
        pa, pb = rk.rd_scan(*rows[kind]), rk.rd_scan_reference(*rows[kind])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(pa, pb)):
            fail(f"K2 is not bit-exact at S=1, F=1 on the {kind} rows")
    L = pipeline.HIST + 1 + F * pipeline.FRAME
    ext = torch.from_numpy(rng.standard_normal((S, L)).astype(f32) * 1e3).to(dev)
    starts = torch.tensor([[1 + (pipeline.PBUF - pipeline.WIN) - 300]], dtype=torch.int32,
                          device=dev)
    k3_err = float((ok.pitch_window_gather(ext, starts)
                    - ok.pitch_window_gather_reference(ext, starts)).abs().max())
    # K4-K6 as the fused monitoring path runs them, one frame a launch
    FR = pipeline.FRAME
    sext = torch.from_numpy(rng.standard_normal((S, pipeline.HIST + 1 + F * FR))
                            .astype(f32) * SPEC_SCALE).to(dev)
    ext_a = sext[:, 1 + pipeline.HIST - FR:]
    wins = torch.from_numpy(rng.standard_normal((S, F, pipeline.WIN)).astype(f32)
                            * SPEC_SCALE).to(dev)
    mem = torch.from_numpy(rng.standard_normal((S, FR)).astype(f32) * SPEC_SCALE).to(dev)
    dft_pad, band = params["dft_fwd_pad"], params["band_e_pad"]
    inva, invb = params["dft_inv_a"], params["dft_inv_b"]
    Yin = fk.fwd_spectrum_bands_reference(ext_a, dft_pad, band, F)[0].contiguous()
    spectra = (("fwd_spectrum_bands", "spectrum_bands_kernel",
                lambda: fk.fwd_spectrum_bands(ext_a, dft_pad, band, F),
                lambda: fk.fwd_spectrum_bands_reference(ext_a, dft_pad, band, F)),
               ("win_spectrum_bands", "spectrum_bands_kernel",
                lambda: fk.win_spectrum_bands(wins, dft_pad, band),
                lambda: fk.win_spectrum_bands_reference(wins, dft_pad, band)),
               ("inv_spectrum_ola", "inv_ola_kernel",
                lambda: fk.inv_spectrum_ola(Yin, inva, invb, mem),
                lambda: fk.inv_spectrum_ola_reference(Yin, inva, invb, mem)))
    spec_errs = {}
    for name, _, kern, plain in spectra:
        (a, b), (ra, rb) = kern(), plain()
        torch.cuda.synchronize()
        # Y (or out) within SPEC_TOL of its max; Ex relative EX_RTOL (or new_mem as out)
        e1 = float((a - ra).abs().max()) / float(ra.abs().max())
        e2 = (float((b - rb).abs().max()) / float(rb.abs().max()) if name == "inv_spectrum_ola"
              else float(((b - rb).abs() / rb.abs()).max()))
        spec_errs[name] = (e1, e2)
        if not (e1 <= SPEC_TOL and e2 <= (SPEC_TOL if name == "inv_spectrum_ola" else EX_RTOL)):
            fail(f"{name} differs from its plain version at S=1, F=1: {e1}, {e2}")
    cases = (("nn_scan", "nn_scan_resident_kernel", k1_err, f"tol {K1_TOL}",
              lambda: rk.nn_scan(params, state, feats, silence),
              lambda: rk.nn_scan_reference(params, state, feats, silence)),
             ("rd_scan", "rd_scan_kernel", 0.0, "bit-exact required",
              lambda: rk.rd_scan(*rows["random"]), lambda: rk.rd_scan_reference(*rows["random"])),
             ("pitch_window_gather", "pitch_gather_kernel", k3_err, "exact required",
              lambda: ok.pitch_window_gather(ext, starts),
              lambda: ok.pitch_window_gather_reference(ext, starts)))
    cases += tuple((name, kname, spec_errs[name][0],
                    f"x its max, tol {SPEC_TOL}; second output {spec_errs[name][1]:.3e}",
                    kern, plain) for name, kname, kern, plain in spectra)
    for name, kname, err, tol, kern, plain in cases:
        ms = cuda_ms(kern, 200)
        dms = device_ms(kern, 50, kname)
        plain_ms = cuda_ms(plain, 20)
        print(f"[2] monitoring shape S=1 F=1: {name} max|kernel-plain|={err:.3e} ({tol}); "
              f"kernel {ms:.4f} ms a call (CUDA events over 200 calls), device time "
              f"{dms:.4f} ms (torch.profiler), plain {plain_ms:.4f} ms")
    if not k1_err <= K1_TOL:
        fail(f"K1 differs from its plain version at S=1, F=1 by {k1_err}")
    if k3_err != 0.0:
        fail(f"K3 is not exact at S=1, F=1: {k3_err}")


class LoggedRing:
    """A recording ring that logs each operation with its length, in the
    order the operations took effect, for the host replay of the mix (and,
    given a ``pushed`` list, keeps each pushed block)."""

    def __init__(self, ring, log, name, gate=None, pushed=None):
        import threading

        self.ring, self.log, self.name, self.gate = ring, log, name, gate
        self.pushed = pushed
        self._lock = threading.Lock()

    def push(self, samples) -> None:
        if self.gate is not None:
            self.gate(self)
        with self._lock:
            self.ring.push(samples)
            self.log.append((self.name, "push", int(np.asarray(samples).size)))
            if self.pushed is not None:
                self.pushed.append(np.array(samples, np.float32))

    def pop(self, n: int):
        with self._lock:
            out = self.ring.pop(n)
            self.log.append((self.name, "pop", int(out.size)))
        return out

    def trim_front(self, n: int) -> None:
        with self._lock:
            before = len(self.ring)
            self.ring.trim_front(n)
            self.log.append((self.name, "trim", before - len(self.ring)))

    def clear(self) -> None:
        with self._lock:
            self.ring.clear()
            self.log.append((self.name, "clear", 0))

    def __len__(self) -> int:
        return len(self.ring)


def replay_mix(log, mic: np.ndarray, app: np.ndarray, frame: int, capacity: int) -> np.ndarray:
    """The mixer worker's output rebuilt on the host from the logged ring
    operations, the monitor's output (the mic feed) and the app track: each
    frame is mic pop + app pop, zero-filled to the frame, as the worker mixes
    it."""
    from collections import deque

    src = {"mic": mic, "app": app}
    pos = {"mic": 0, "app": 0}
    rings = {"mic": deque(), "app": deque()}
    pops = {"mic": [], "app": []}
    for name, op, n in log:
        r = rings[name]
        if op == "push":
            r.extend(src[name][pos[name]: pos[name] + n].tolist())
            pos[name] += n
            while len(r) > capacity:
                r.popleft()
        elif op == "pop":
            pops[name].append(np.array([r.popleft() for _ in range(n)], np.float32))
        elif op == "trim":
            for _ in range(n):
                r.popleft()
        else:
            r.clear()
    if pos["mic"] != mic.size:
        fail(f"the mic ring took {pos['mic']} samples, the monitor gave {mic.size}")
    frames = []
    for m, a in zip(pops["mic"], pops["app"]):
        frames.append(np.pad(m, (0, frame - m.size)) + np.pad(a, (0, frame - a.size)))
    return np.concatenate(frames) if frames else np.zeros(0, np.float32)


def percentiles(ms) -> str:
    a = np.asarray(ms)
    return (f"median {np.median(a):.4f}, p99 {np.percentile(a, 99):.4f}, max {a.max():.4f} ms "
            f"over {a.size} frames")


def graph_vs_eager(torch, pipeline, params, model, dev, rng) -> None:
    """Phase 9a: GraphedBlockStep against the eager step and the oracle, on
    each spectra path, over MON_FRAMES frames at S=1, F=1.

    The oracle is held at F32_TOL on every frame but a frame whose pitch
    index differs from the oracle's and the frame after it (its synthesis
    tail overlaps that one): a pitch index one apart at a near-tie of the
    pitch search is a legitimate result in f32, and the JAX package's own
    single-frame step takes the same one on this audio. Such frames are
    counted and printed with their error; more than 1% of them, or indices
    more than 2 apart, fail."""
    from crispy_tpu_torch.dsp.rnnoise import oracle
    from crispy_tpu_torch.dsp.rnnoise.graphed import GraphedBlockStep

    FR = pipeline.FRAME
    x = speechlike(MON_FRAMES * FR, rng, 130.0)
    frames = x.reshape(MON_FRAMES, FR)
    ost = oracle.DenoiseState(model=model)
    want, pitch_oracle = [], []
    for f in frames:
        out, _ = ost.process_frame(f * np.float32(32768.0))
        want.append(out / np.float32(32768.0))
        pitch_oracle.append(ost.last_period)
    want, pitch_oracle = np.stack(want), np.array(pitch_oracle)
    for path in ("off", "on"):
        with spectra_path(path), torch.no_grad():
            t0 = time.perf_counter()
            step = GraphedBlockStep(params, 1, 1, dev)
            t_capture = time.perf_counter() - t0
            got = np.stack([step.step(f[None]).numpy()[0] for f in frames])
            state = pipeline.init_state(1, dev)
            eager, pitch = [], []
            for f in frames:
                state, o, _ = pipeline.denoise_block(params, state,
                                                     torch.from_numpy(f[None]).to(dev))
                eager.append(o.cpu().numpy()[0])
                pitch.append(int(state["last_period"][0]))
            eager, pitch = np.stack(eager), np.array(pitch)
        n_diff = int(np.sum(got != eager))
        err = np.abs(got - want).max(axis=1)
        flips = np.nonzero(pitch != pitch_oracle)[0]
        near = np.zeros(MON_FRAMES, bool)
        near[flips] = True
        near[np.minimum(flips + 1, MON_FRAMES - 1)] = True
        o_err = float(err[~near].max())
        print(f"[9a] {'fused' if path == 'on' else 'FFT'} path: GraphedBlockStep (warm-up and "
              f"capture {t_capture:.2f} s) over {MON_FRAMES} frames vs eager denoise_block on the "
              f"card at S=1, F=1: {n_diff} samples differ (bit-equal required); vs the port's "
              f"oracle max|diff|={o_err:.3e} (tol {F32_TOL}) on the frames whose pitch index is "
              f"the oracle's; pitch index differs on frames {flips.tolist()} (card "
              f"{pitch[flips].tolist()}, oracle {pitch_oracle[flips].tolist()}), max|diff| "
              f"{float(err[near].max()) if near.any() else 0.0:.3e} on them and the frames "
              f"after them")
        if n_diff:
            fail(f"the graphed step differs from the eager step on the {path} path")
        if not o_err <= F32_TOL:
            fail(f"the graphed step differs from the oracle by {o_err} on the {path} path")
        if flips.size > MON_FRAMES // 100 or np.any(np.abs(pitch - pitch_oracle) > 2):
            fail(f"the pitch track departs from the oracle's on the {path} path: {flips}")


def monitor_and_record(tmp: Path, rng, kernels: dict) -> dict:
    """Phase 9b, the slice's main path: MonitoringEngine (realtime off, the
    rnnoise model, default device: the card) on a MON_SECONDS 48 kHz device,
    its mic_tap feeding a recording started by do_start_recording with a
    FileSource app track. The WAV is held to a host replay of the mix.
    Returns the kernel launches of the run."""
    from crispy_tpu_torch import runtime
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import monitoring, recording
    from crispy_tpu_torch.io import wav as wavio

    FR = 480
    n = MON_SECONDS * 48000
    mic_in = speechlike(n, rng, 115.0)
    app_pcm = (np.clip(speechlike(n, rng, 240.0, level=0.3), -1, 1) * 32767).astype(np.int16)
    app_wav = wavio.write_wav(tmp / "app.wav", app_pcm, 48000)
    app_track, _ = wavio.read_wav_mono(app_wav)
    feed = {"i": 0}

    def device_fn(k):
        i = feed["i"]
        feed["i"] += k
        return mic_in[i: i + k]

    reg = monitoring.DeviceRegistry()
    reg.register(monitoring.InputDevice("speech", device_fn, 48000.0))
    state = recording.RecordingState()
    log = []
    source = recording.FileSource(app_wav, block=FR)

    def app_gate(ring):
        # the app track arrives in step with the mic, as two live captures
        # would, not all at once into its 10 s ring
        while len(ring) > len(state.mic_ring) + recording.MIX_FRAME and not source._stop.is_set():
            time.sleep(0.0002)

    state.mic_ring = LoggedRing(state.mic_ring, log, "mic")
    state.app_ring = LoggedRing(state.app_ring, log, "app", gate=app_gate)
    bus = EventBus()
    bus.keep_history = True
    mon_out = []
    eng = monitoring.MonitoringEngine(registry=reg, bus=bus, output_sink=mon_out.append,
                                      mic_tap=state.mic_ring.push)
    eng.realtime = False
    for k, attr in kernels.values():
        setattr(k, attr, 0)
    t0 = time.perf_counter()
    wav = recording.do_start_recording(state, app_source=source, recordings_dir=tmp / "rec")
    eng.start_monitoring("speech", model_name="rnnoise")
    eng._thread.join(timeout=300)
    if eng.active:
        fail("the monitor loop did not reach the end of its input")
    eng.stop_monitoring()
    deadline = time.time() + 30
    while len(state.mic_ring) >= recording.MIX_FRAME and time.time() < deadline:
        time.sleep(0.01)
    out_path = Path(recording.do_stop_recording(state))
    wall = time.perf_counter() - t0
    launches = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
    mic_out = np.concatenate(mon_out)
    rec_audio, rec_sr = wavio.read_wav(out_path)
    fmt = wavio.read_format(out_path)
    expect = replay_mix(log, mic_out, app_track, recording.MIX_FRAME, recording.RING_CAPACITY)
    exp16 = np.trunc(np.clip(expect, -1.0, 1.0) * 32767.0)
    got16 = np.round(rec_audio * 32768.0)
    lsb = int(np.abs(got16[:, 0] - exp16).max()) if got16.shape[0] == exp16.size else None
    trims = [(nm, k) for nm, op, k in log if op == "trim"]
    app_used = sum(k for nm, op, k in log if nm == "app" and op == "pop")
    levels = [p for e, p in bus.history if e == "microphone-level"]
    timing = [p for e, p in bus.history if e == "stage-timing"]
    print(f"[9b] MonitoringEngine (realtime off) on a {MON_SECONDS} s 48 kHz device -> mic_tap -> "
          f"recording with a FileSource app track: wall {wall:.2f} s, monitor output "
          f"{mic_out.size} samples, {len(levels)} microphone-level and {len(timing)} stage-timing "
          f"events (max_ms {[t['max_ms'] for t in timing]}, budget "
          f"{timing[0]['budget_ms'] if timing else None} ms); host tier: "
          f"{'native C++ (g++)' if runtime.available() else 'Python fallback'}; launches "
          f"{launches}")
    print(f"[9b] recording {out_path.name}: {fmt.sample_rate if fmt else None} Hz, "
          f"{fmt.num_channels if fmt else None} channels, {fmt.bits_per_sample if fmt else None} "
          f"bits, {rec_audio.shape[0]} frames, {app_used} app samples mixed; host replay of the "
          f"mix from {len(log)} logged ring operations ({len(trims)} desync trims "
          f"{trims[:4]}): max {lsb} LSB (tol {I16_TOL}); L == R: "
          f"{bool(np.array_equal(rec_audio[:, 0], rec_audio[:, 1]))}")
    if out_path != wav or fmt is None or (rec_sr, fmt.num_channels, fmt.bits_per_sample) != \
            (48000, 2, 16):
        fail(f"the recording is not 48 kHz stereo s16: {fmt}")
    if not np.array_equal(rec_audio[:, 0], rec_audio[:, 1]):
        fail("the recording's channels differ")
    if mic_out.size != n or not np.isfinite(mic_out).all():
        fail(f"the monitor gave {mic_out.size} samples for {n}")
    if lsb is None or lsb > I16_TOL:
        fail(f"the recording differs from the host replay of the mix: {lsb} LSB, "
             f"{got16.shape[0]} frames for {exp16.size}")
    if not levels or not timing or timing[0]["budget_ms"] != 10.0:
        fail("the monitor emitted no microphone-level or stage-timing event")
    return launches


def frame_latency(torch, pipeline, params, dev, rng, card: str) -> None:
    """Phase 9c, 9d, 9e: push_block's per-frame latency through the graph
    (the gate: median within the 10 ms frame budget), the graphed step's
    alone and the eager step's for the record, push_block's again under a
    batch load, and the graph's kernels under torch.profiler."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
    from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
    from crispy_tpu_torch.dsp.rnnoise.graphed import GraphedBlockStep
    from crispy_tpu_torch.engine import denoiser

    FR = pipeline.FRAME
    proc = denoiser.RnnNoiseProcessor(48000, 48000, 1.0, params=params)  # the card
    xs = speechlike((LAT_FRAMES + 1) * FR, rng, 150.0)
    proc.push_block(xs[:FR])

    def latencies():
        out = []
        for i in range(1, LAT_FRAMES + 1):
            t0 = time.perf_counter()
            proc.push_block(xs[i * FR: (i + 1) * FR])
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    lat = latencies()
    bare = GraphedBlockStep(params, 1, 1, dev)
    step_ms = []
    for i in range(LAT_FRAMES):
        t0 = time.perf_counter()
        bare.step(xs[None, i * FR: (i + 1) * FR])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    state = pipeline.init_state(1, dev)
    eager_ms = []
    with torch.no_grad():
        for i in range(EAGER_FRAMES):
            t0 = time.perf_counter()
            blk = torch.from_numpy(xs[None, i * FR: (i + 1) * FR]).to(dev)
            state, o, _ = pipeline.denoise_block(params, state, blk)
            o.cpu()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(lat))
    print(f"[9c] RnnNoiseProcessor.push_block, one 480-sample frame through the graph: "
          f"{percentiles(lat)}; GraphedBlockStep.step alone (copy in, replay, copy out): "
          f"{percentiles(step_ms)}; the eager step (upload, denoise_block, download), for the "
          f"record: {percentiles(eager_ms[5:])}; budget 10 ms [{card}]")
    if not med <= 10.0:
        fail(f"the graphed per-frame median {med:.3f} ms exceeds the 10 ms frame budget")

    batch = np.tile(np.stack([speechlike(F_MAIN * FR, rng, 90.0 + s) for s in range(S_MAIN)]),
                    (1, 4))
    stop, blocks = threading.Event(), [0]

    def load():
        while not stop.is_set():
            pipeline.denoise_batch(batch, params=params)
            blocks[0] += 4

    th = threading.Thread(target=load, daemon=True)
    th.start()
    time.sleep(1.0)
    lat_load = latencies()
    stop.set()
    th.join(timeout=120)
    print(f"[9d] the same under load (denoise_batch S={S_MAIN}, F={F_MAIN} in another thread, "
          f"{blocks[0]} blocks during the run): {percentiles(lat_load)} [{card}]")

    before = (rk.nn_scan.launches, rk.rd_scan.launches, ok.pitch_window_gather.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_FRAMES):
            proc.push_block(xs[i * FR: (i + 1) * FR])
        torch.cuda.synchronize()
    rose = (rk.nn_scan.launches - before[0], rk.rd_scan.launches - before[1],
            ok.pitch_window_gather.launches - before[2])
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    by_name = {k: sum(e.count for e in evs if k in e.key)
               for k in ("nn_scan_resident_kernel", "rd_scan_kernel", "pitch_gather_kernel")}
    copies = sum(e.count for e in evs if "Memcpy" in e.key or "Memset" in e.key)
    n_kern = sum(e.count for e in evs) - copies
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"[9e] torch.profiler over {PROFILE_FRAMES} replays: {by_name}; "
          f"{n_kern / PROFILE_FRAMES:.1f} kernels and {copies / PROFILE_FRAMES:.1f} copies a "
          f"frame, device time {dev_ms / PROFILE_FRAMES:.4f} ms a frame; the counters of K1, "
          f"K2, K3 rose by {rose} [{card}]")
    if any(c != PROFILE_FRAMES for c in by_name.values()) or rose != (PROFILE_FRAMES,) * 3:
        fail(f"the profile or the counters do not show K1-K3 once a replay: {by_name}, {rose}")


def config2(torch, dev, tmp: Path, rng, card: str) -> None:
    """Phase 9f: the resample command on a 44.1 kHz WAV, and config 2 on the
    card: CFG2_SECONDS of 44.1 kHz resampled to 48 kHz, added to a 48 kHz
    track and stacked dual mono, by CUDA events (printed only)."""
    import io

    from crispy_tpu_torch import cli
    from crispy_tpu_torch.dsp.resample import make_resampler
    from crispy_tpu_torch.io import wav as wavio

    src, dst = tmp / "in441.wav", tmp / "out48.wav"
    wavio.write_wav(src, np.stack([speechlike(441000, rng, 120.0, sr=44100),
                                   speechlike(441000, rng, 180.0, sr=44100)], axis=1), 44100)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(["resample", str(src), str(dst), "--rate", "48000"])  # the card
    t_cli = time.perf_counter() - t0
    r48, sr48 = wavio.read_wav(dst)
    if rc != 0 or sr48 != 48000 or r48.shape != (480000, 2):
        fail(f"the resample command gave rc {rc}, {sr48} Hz, shape {r48.shape}")
    mic44 = torch.from_numpy((rng.standard_normal(CFG2_SECONDS * 44100) * 0.3)
                             .astype(np.float32)).to(dev)
    app48 = torch.from_numpy((rng.standard_normal(CFG2_SECONDS * 48000) * 0.3)
                             .astype(np.float32)).to(dev)
    res = make_resampler(44100, 48000, dev)

    def mix():
        mic48 = res(mic44)
        m = min(mic48.numel(), app48.numel())
        mixed = mic48[:m] + app48[:m]
        return torch.stack([mixed, mixed], dim=1)  # dual mono (recording.rs R3)

    shape = tuple(mix().shape)
    ms = cuda_ms(mix, 5)
    print(f"[9f] resample command on a 10 s 44.1 kHz stereo WAV, to 48 kHz on the card: "
          f"{t_cli:.2f} s wall, said {said.getvalue().strip()}; config 2 on the card "
          f"({CFG2_SECONDS} s of 44.1 kHz to 48 kHz, added to a 48 kHz track, dual mono "
          f"{shape}): {ms:.3f} ms (CUDA events, mean of 5) = {CFG2_SECONDS * 1e3 / ms:.0f}x "
          f"realtime [{card}]")


# ---------------------------------------------------------------------------
# Phase 10: the native ASR families
# ---------------------------------------------------------------------------

def asr_chunks(rng, B: int) -> np.ndarray:
    """B speech-like 30 s chunks at 16 kHz, each on its own pitch."""
    return np.stack([speechlike(ASR_SECONDS * 16000, rng, 95.0 + 23.0 * b, sr=16000)
                     for b in range(B)])


def near_tie(ties: list, family: str, where: str, cpu_logits, card_pick: int,
             cpu_pick: int, tol: float = TIE_RTOL) -> None:
    """A card decision that differs from the CPU path's passes only at a
    near-tie: the CPU's top-two margin at that step below ``tol`` of the
    step's largest |logit|. Printed and counted."""
    lg = np.asarray(cpu_logits, np.float64)
    top2 = np.sort(lg)[-2:]
    ratio = float((top2[1] - top2[0]) / np.abs(lg).max())
    print(f"[10] {family}: a decision differs card vs CPU at {where}: card {card_pick}, CPU "
          f"{cpu_pick}; CPU top-two margin {ratio:.3e} of the step's largest |logit| "
          f"(passes below {tol})")
    if not ratio < tol:
        fail(f"{family}: the card's decision at {where} differs from the CPU's off a near-tie")
    ties.append((family, where, ratio))


def check_picks(ties: list, family: str, card_ids, cpu_ids, cpu_logits,
                independent: bool) -> bool:
    """Rows of decisions card vs CPU, with the CPU logits behind each
    [B, steps, V]. CTC frames are independent decisions: every differing
    frame must be a near-tie. Greedy tokens feed the next step: the first
    differing step must be, the steps after it follow other inputs. Returns
    whether all agree."""
    same = True
    for b, (c, h) in enumerate(zip(card_ids, cpu_ids)):
        diff = np.nonzero(np.asarray(c) != np.asarray(h))[0]
        for s in diff if independent else diff[:1]:
            near_tie(ties, family, f"row {b} step {int(s)}", cpu_logits[b, s], int(c[s]),
                     int(h[s]))
            same = False
    return same


def tdt_trace(pk, model, enc):
    """The TDT loop step by step with the host reading the end each
    iteration: the state and each step's (token, duration) logits."""
    s = pk.tdt_init(model, enc, 256)
    steps = []
    while bool((s["t"] < s["T"]).any()) and len(steps) < s["T"] + 256:
        tl, dl = pk.tdt_step(model, s)
        steps.append((tl[0].cpu().numpy(), dl[0].cpu().numpy()))
    return s, steps


@contextlib.contextmanager
def recorded(module, name: str, keep=None):
    """Every return of ``module.name`` while the block runs, in a list (or
    what ``keep`` takes of it): what an engine's own calls computed, with
    nothing run again."""
    fn, out = getattr(module, name), []

    def rec(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append(res if keep is None else keep(res))
        return res

    setattr(module, name, rec)
    try:
        yield out
    finally:
        setattr(module, name, fn)


def profile_call(torch, fn, cpu: bool = True) -> dict:
    """One call of fn under torch.profiler: kernel launches, device time,
    wall time (host clock, synchronised). ``cpu=False`` traces the card
    alone, which reads back faster."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = [e for e in evs if not e.key.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    return {"launches": sum(e.count for e in kernels), "device_ms": dev_ms,
            "wall_ms": wall_ms, "busy_share": dev_ms / wall_ms,
            "top": [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
                    for e in top]}


def launch_us(torch) -> float:
    """Host microseconds a launch of a one-element in-place add, over
    PROBE_LAUNCHES launches (synchronised) after as many to warm up: how fast
    this process, in its state at the call, feeds the card."""
    x = torch.zeros(1, device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROBE_LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / PROBE_LAUNCHES * 1e6


def train_step_ms(torch, dev) -> float:
    """Median host ms of one training step (masked loss, autograd's backward,
    Adam; synchronised) at B=TRAIN_B x F=TRAIN_F on one fixed batch, over
    STEP_PROBE_STEPS steps after one to warm up: the same work early and late
    in the smoke, so the two readings show what the process's state costs
    [14c]'s steps."""
    from crispy_tpu_torch.dsp.rnnoise import pipeline, training
    from crispy_tpu_torch.parallel import train as ptrain

    batch = training.make_batch(pipeline.make_params(None, dev), np.random.default_rng(0),
                                TRAIN_B, TRAIN_F)
    step, to_device_params, _, optimizer = ptrain.make_train_step(dev)
    net = to_device_params(ptrain.init_train_params())
    opt = optimizer(net)
    ms = []
    for _ in range(STEP_PROBE_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net, opt, _ = step(net, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:]))


def process_cpu() -> dict:
    """CPU seconds (user + system) of every process on the host but this
    one, by pid, with its name."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit() or int(proc.name) == os.getpid():
            continue
        try:
            stat = (proc / "stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[int(proc.name)] = (stat[stat.index("(") + 1: stat.rindex(")")],
                               (int(fields[11]) + int(fields[12])) / tick)
    return out


def thread_cpu() -> dict:
    """CPU seconds (user + system) of each of this process's threads, by
    native id, with the thread's name."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for task in Path("/proc/self/task").iterdir():
        try:
            stat = (task / "stat").read_text()
            name = (task / "comm").read_text().strip()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[int(task.name)] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def fresh_probes() -> Tuple[float, float]:
    """launch_us and train_step_ms in a new process on the card, started
    now: the host at this moment, without this process's state."""
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
            "print(json.dumps([cs.launch_us(torch), "
            "cs.train_step_ms(torch, torch.device('cuda'))]))")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        fail(f"the probes' process failed (exit {proc.returncode})")
    return tuple(json.loads(proc.stdout.strip().splitlines()[-1]))


@contextlib.contextmanager
def gc_time():
    """Seconds the cyclic garbage collector spends while the block runs, by
    generation, with the number of collections: {gen: [seconds, count]}."""
    import gc

    spent, started = {0: [0.0, 0], 1: [0.0, 0], 2: [0.0, 0]}, [0.0]

    def cb(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            spent[info["generation"]][0] += time.perf_counter() - started[0]
            spent[info["generation"]][1] += 1

    gc.callbacks.append(cb)
    try:
        yield spent
    finally:
        gc.callbacks.remove(cb)


@contextlib.contextmanager
def call_inputs(module, name: str):
    """The positional arguments of every call of ``module.name`` while the
    block runs, in a list (the tensors cloned as they came in)."""
    fn, out = getattr(module, name), []

    def rec(*args):
        out.append(tuple(a.clone() for a in args))
        return fn(*args)

    setattr(module, name, rec)
    try:
        yield out
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def path_k23_inputs(pipeline):
    """K2 and K3's inputs as the pipeline's frontend gives them while the
    block runs: (rd_scan calls, pitch_window_gather calls)."""
    with call_inputs(pipeline, "rd_scan") as rd, \
            call_inputs(pipeline, "pitch_window_gather") as pg:
        yield rd, pg


def check_k23(torch, rk, ok, rd_calls, pg_calls, where: str) -> str:
    """K2 and K3 on the inputs a path gave them, against their plain versions
    on the same tensors on the card and on copies on the CPU: bit-equal
    required, as in phase 2. Returns the line's text."""
    if not (rd_calls and pg_calls):
        fail(f"{where}: the path made no K2 or K3 call ({len(rd_calls)}, {len(pg_calls)})")
    shapes = []
    for name, calls, kern, plain in (("rd_scan", rd_calls, rk.rd_scan, rk.rd_scan_reference),
                                     ("pitch_window_gather", pg_calls, ok.pitch_window_gather,
                                      ok.pitch_window_gather_reference)):
        for args in calls:
            got = kern(*args)
            ref = plain(*args)
            ref_cpu = plain(*(a.cpu() for a in args))
            got, ref, ref_cpu = ((t,) if isinstance(t, torch.Tensor) else tuple(t)
                                 for t in (got, ref, ref_cpu))
            if not all(torch.equal(a, b) and torch.equal(a.cpu(), c)
                       for a, b, c in zip(got, ref, ref_cpu)):
                fail(f"{where}: {name} differs from its plain version on the path's own "
                     f"inputs {[tuple(a.shape) for a in args]}")
            shapes.append(f"{name} {tuple(args[0].shape)}")
    return (f"K2 and K3 on the path's own inputs ({', '.join(shapes)}) bit-equal to their plain "
            f"versions on the card and on the CPU")


def engine_rtf(torch, eng, x) -> Tuple[float, List[str]]:
    """Host wall of one transcribe_batch call on x (after a warm-up call) over
    the audio it holds, and its texts."""
    eng.transcribe_batch(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = eng.transcribe_batch(x)
    wall = time.perf_counter() - t0
    return wall / (x.shape[0] * x.shape[1] / 16000), texts


def write_bundle(path: Path, params: dict, config: dict, pieces=None, types=None) -> None:
    from crispy_tpu_torch.models.spm import build_model_bytes

    path.mkdir(parents=True)
    np.savez(path / "params.npz", **params)
    (path / "config.json").write_text(json.dumps(config))
    if pieces is not None:
        (path / "tokenizer.model").write_bytes(build_model_bytes(pieces, types))


def parakeet_cells(torch, mm, rng, card: str, ties: list) -> None:
    """[10a] parakeet-tdt-0.6b at its published widths through load_engine on
    the card, against the port's CPU path; [10b] run_transcription of a 5 min
    48 kHz WAV through it."""
    from dataclasses import asdict

    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.dsp.asr_frontend import nemo_log_mel, nemo_raw_log_mel, valid_frames
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.io import wav as wavio
    from crispy_tpu_torch.models import parakeet as pk
    from crispy_tpu_torch.models.spm import NORMAL, UNKNOWN

    mid = "parakeet-tdt-0.6b-v2"
    cfg = pk.CONFIGS["parakeet-tdt-0.6b"]
    t0 = time.perf_counter()
    params = pk.init_random(cfg, 0)
    n_params = sum(v.size for v in params.values())
    enc_cfg = {k: v for k, v in asdict(cfg).items() if k != "durations"}
    write_bundle(mm.model_path(mid), params, {"encoder": enc_cfg},
                 ["<unk>"] + [f"▁p{i}" for i in range(cfg.vocab_size - 1)],
                 [UNKNOWN] + [NORMAL] * (cfg.vocab_size - 1))
    del params
    t1 = time.perf_counter()
    eng = tr.load_engine(mid, mm)  # default device: the card
    t2 = time.perf_counter()
    cpu = tr.load_engine(mid, mm, device="cpu")
    model, cpu_model = eng.model, cpu.model
    if not next(model.parameters()).is_cuda:
        fail("the parakeet engine did not load onto the card")
    print(f"[10a] {mid}: {n_params / 1e6:.1f} M random f32 weights (seed 0) at its published "
          f"widths (d={cfg.hidden_size}, {cfg.layers} layers, {cfg.heads} heads, FF "
          f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, durations {cfg.durations}): "
          f"init + bundle {t1 - t0:.1f} s, load_engine on the card {t2 - t1:.1f} s")

    # one 30 s chunk: the card against the CPU path
    t0 = time.perf_counter()
    x = asr_chunks(rng, ASR_BATCH)
    xc = torch.from_numpy(x).cuda()
    x1, x1c = torch.from_numpy(x[:1]), xc[:1]
    fh, fc = nemo_log_mel(x1, cfg.n_mels), nemo_log_mel(x1c, cfg.n_mels)
    feat_err = rel_err(fc, fh)
    bits = int((valid_frames(nemo_raw_log_mel(x1c, cfg.n_mels)).cpu()
                != valid_frames(nemo_raw_log_mel(x1, cfg.n_mels))).sum())
    eh = pk.encode(cpu_model, fh.transpose(1, 2))
    ec = pk.encode(model, fc.transpose(1, 2))
    enc_err = rel_err(ec, eh)
    sc, steps_c = tdt_trace(pk, model, ec)
    sh, steps_h = tdt_trace(pk, cpu_model, eh)
    toks, n, _ = pk.tdt_decode(model, ec)
    if not (torch.equal(toks, sc["toks"]) and torch.equal(n, sc["n"])):
        fail("the card's TDT loop differs from its own step-by-step trace")
    diverged = None
    for i, ((tc, dc), (th, dh)) in enumerate(zip(steps_c, steps_h)):
        for head, lc, lh in (("token", tc, th), ("duration", dc, dh)):
            if int(lc.argmax()) != int(lh.argmax()):
                near_tie(ties, mid, f"iteration {i} ({head})", lh, int(lc.argmax()),
                         int(lh.argmax()))
                diverged = i
                break
        if diverged is not None:
            break
    same = torch.equal(sc["toks"].cpu(), sh["toks"]) and torch.equal(sc["n"].cpu(), sh["n"])
    print(f"[10a] card vs CPU on one 30 s chunk: features max|diff| {feat_err:.3e} of their "
          f"largest magnitude (tol {FEAT_RTOL}), valid-frame bits differing {bits} of "
          f"{fh.shape[-1]}; encoder output {enc_err:.3e} of its largest magnitude (tol "
          f"{PK_ENC_RTOL}); TDT {len(steps_c)} iterations on the card, {len(steps_h)} on the "
          f"CPU, tokens and n equal {same} (n = {int(sh['n'][0])}), first divergence "
          f"{diverged} ({time.perf_counter() - t0:.1f} s)")
    if not (feat_err <= FEAT_RTOL and enc_err <= PK_ENC_RTOL):
        fail(f"parakeet card vs CPU: features {feat_err}, encoder {enc_err}")
    if diverged is None and not (same and len(steps_c) == len(steps_h)):
        fail("parakeet TDT tokens differ card vs CPU with no divergent decision")

    # B=8: the frontend, the encoder, the decode loop by CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    eng.transcribe_batch(xc)  # warm-up
    torch.cuda.synchronize()
    ev[0].record()
    feats = nemo_log_mel(xc, cfg.n_mels).transpose(1, 2)
    ev[1].record()
    enc = pk.encode(model, feats)
    ev[2].record()
    _, n8, iters = pk.tdt_decode(model, enc)
    ev[3].record()
    torch.cuda.synchronize()
    fe_ms, enc_ms, dec_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    iters = int(iters)
    prof = profile_call(torch, lambda: pk.tdt_decode(model, enc))
    rtf, texts = engine_rtf(torch, eng, xc)
    audio_s = ASR_BATCH * ASR_SECONDS
    print(f"[10a] B={ASR_BATCH} x 30 s on the card (CUDA events): frontend {fe_ms:.3f} ms, "
          f"encoder {enc_ms:.3f} ms, TDT decode loop {dec_ms:.3f} ms over {iters} iterations "
          f"({dec_ms / iters:.4f} ms each; host checks of the end every "
          f"{pk.TDT_SYNC_EVERY}: {-(-iters // pk.TDT_SYNC_EVERY)} syncs), tokens per row "
          f"{n8.tolist()}; transcribe_batch host to host RTF {rtf:.4e} ({rtf * audio_s:.3f} s "
          f"for {audio_s} s) [{card}]")
    print(f"[10a] torch.profiler over one decode loop at B={ASR_BATCH}: {prof['launches']} "
          f"kernel launches = {prof['launches'] / iters:.1f} per iteration, device time "
          f"{prof['device_ms']:.3f} ms: device busy {100 * prof['device_ms'] / dec_ms:.1f}% of "
          f"the loop timed above ({100 * prof['busy_share']:.1f}% of its {prof['wall_ms']:.3f} "
          f"ms under the profiler); top kernels {prof['top']}")
    if len(texts) != ASR_BATCH or not all(texts):
        fail(f"the parakeet engine returned empty texts: {texts}")

    # [10b] a 5 min 48 kHz WAV through run_transcription and load_engine
    sr = 48000
    pcm = (np.clip(speechlike(ASR_E2E_SECONDS * sr, rng, 130.0, sr=sr), -1.0, 1.0)
           * 32767.0).astype(np.int16)
    wav = wavio.write_wav(mm.models_dir.parent / "talk10.wav", pcm, sr)
    bus = EventBus()
    bus.keep_history = True
    seen, outs = [], []

    def loader(model_id, m):
        e = eng  # the engine load_engine gave in [10a], on the card
        inner = e.transcribe_batch

        def recording(chunks, language="en"):
            seen.append((type(chunks).__name__, str(getattr(chunks, "device", "host")),
                         tuple(chunks.shape)))
            outs.append(inner(chunks, language=language))
            return outs[-1]

        e.transcribe_batch = recording
        return e

    tm = tr.TranscriptionManager(mm, bus=bus, engine_loader=loader)
    t0 = time.perf_counter()
    text = tr.run_transcription(str(wav), tm, mid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = tm.get_state(str(wav))
    progress = [p["progress"] for e, p in bus.history if e == "transcription-progress"]
    stages = [(p["stage"], round(p["seconds"], 4), {k: v for k, v in p.items()
                                                     if k not in ("stage", "seconds")})
              for e, p in bus.history if e == "stage-timing"]
    live = [p["chunks"] for e, p in bus.history
            if e == "stage-timing" and p["stage"] == "transcribe-batch"]
    print(f"[10b] run_transcription of a {ASR_E2E_SECONDS} s 48 kHz 16-bit WAV through the "
          f"{mid} engine of [10a]: status {st.status if st else None}, wall {wall:.3f} s, RTF "
          f"{wall / ASR_E2E_SECONDS:.3e} (the model loaded before), chunk batches {seen}, "
          f"progress {progress}, {len(text)} characters [{card}]")
    print(f"[10b] stage-timing events (host clock): {stages}")
    if st is None or st.status != "completed" or tr.load_transcription_result(str(wav)) != text:
        fail(f"parakeet run_transcription ended in {st}")
    if sum(live) != -(-ASR_E2E_SECONDS // ASR_SECONDS) or not all(
            all(o[:k]) for o, k in zip(outs, live)):
        fail(f"a chunk came back without text: {live}, {[[len(t) for t in o] for o in outs]}")
    if any(kind != "Tensor" or not d.startswith("cuda") for kind, d, _ in seen):
        fail(f"a chunk batch was not a tensor on the card: {seen}")


def decode_loop_profile(torch, mid: str, model, x, prompt_ids) -> None:
    """Launches a decode step and the device's busy share in the greedy loop
    of canary or moonshine at B=8: a greedy call of PROFILE_STEPS new tokens
    less its encoder, under torch.profiler for the launches and the device
    time, and again without it for the wall (the profiler's own host cost
    would lengthen it)."""
    from crispy_tpu_torch.dsp.asr_frontend import nemo_log_mel
    from crispy_tpu_torch.models import canary as cn
    from crispy_tpu_torch.models import moonshine as ms

    if mid == "canary-180m-flash":
        feats = nemo_log_mel(x, model.cfg.encoder.n_mels).transpose(1, 2)
        prompt = torch.tensor(prompt_ids, device=x.device).expand(x.shape[0], -1)
        calls = (lambda: cn.greedy_decode(model, feats, max_new=PROFILE_STEPS, prompt=prompt),
                 lambda: cn.encode(model, feats))
        steps = len(prompt_ids) + PROFILE_STEPS - 1  # the prompt's prefill included
    else:
        calls = (lambda: ms.greedy_decode(model, x, max_new=PROFILE_STEPS),
                 lambda: ms.encode(model, x))
        steps = PROFILE_STEPS  # the start token, then max_new - 1 steps
    full, enc = (profile_call(torch, fn) for fn in calls)
    walls = []
    for fn in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = full["launches"] - enc["launches"]
    dev_ms, wall_ms = full["device_ms"] - enc["device_ms"], walls[0] - walls[1]
    print(f"[10c] {mid} decode loop at B={x.shape[0]}, {steps} steps (a greedy call less "
          f"its encoder): {launches / steps:.1f} launches a step (torch.profiler), "
          f"{wall_ms / steps:.3f} ms a step (host clock), device busy "
          f"{100 * dev_ms / wall_ms:.1f}%; encoder {walls[1]:.3f} ms; top kernels "
          f"{full['top'][:3]}")


def family_cells(torch, mm, rng, card: str, ties: list) -> None:
    """[10c] one batch of 30 s chunks on the card against the CPU path for
    gigaam, canary-180m-flash, moonshine-base and sense-voice-small."""
    from dataclasses import asdict

    from crispy_tpu_torch.dsp.asr_frontend import nemo_log_mel
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models import canary as cn
    from crispy_tpu_torch.models import moonshine as ms
    from crispy_tpu_torch.models import parakeet as pk
    from crispy_tpu_torch.models import sensevoice as sv
    from crispy_tpu_torch.models.spm import CONTROL, NORMAL, UNKNOWN

    # the GigaAM widths of the JAX package's own bundle test (tests/test_spm.py)
    giga = dict(n_mels=64, hidden_size=64, layers=2, heads=2, kv_heads=2,
                intermediate_size=128, sub_channels=32, sub_factor=4, vocab_size=34)
    ccfg, mcfg, scfg = (cn.CONFIGS["canary-180m-flash"], ms.CONFIGS["moonshine-base"],
                        sv.CONFIGS["sense-voice-small"])
    c_pieces = (["<unk>", "<s>", "</s>", "<|en|>", "<|transcribe|>"]
                + [f"▁c{i}" for i in range(ccfg.vocab_size - 5)])
    c_prompt = [ccfg.bos, 3, 4, 3]
    s_prompt = [1, 2, 3, 4]
    families = {
        "gigaam-v3-e2e-ctc": (
            lambda: pk.init_random(pk.ParakeetConfig(**giga), 0),
            {"encoder": giga, "labels": [" "] + [chr(0x430 + i) for i in range(32)] + ["ё"]},
            None, None),
        "canary-180m-flash": (
            lambda: cn.init_random(ccfg, 0),
            {"config": "canary-180m-flash", "prompt_ids": c_prompt}, c_pieces,
            [UNKNOWN, CONTROL, CONTROL, CONTROL, CONTROL] + [NORMAL] * (ccfg.vocab_size - 5)),
        "moonshine-base": (lambda: ms.init_random(mcfg, 0), {"config": "moonshine-base"},
                           None, None),
        "sense-voice-int8": (
            lambda: sv.init_random(scfg, 0),
            {"config": "sense-voice-small", "prompt_ids": s_prompt},
            ["<blank>"] + [f"▁s{i}" for i in range(scfg.vocab_size - 1)],
            [CONTROL] + [NORMAL] * (scfg.vocab_size - 1)),
    }

    def forced_logits(model, mid, x, toks):
        """The logits behind each greedy token: the decoder teacher-forced
        along the tokens."""
        if mid == "canary-180m-flash":
            feats = nemo_log_mel(x, ccfg.encoder.n_mels).transpose(1, 2)
            prompt = torch.tensor(c_prompt).expand(x.shape[0], -1)
            seq = torch.cat([prompt, toks[:, :-1]], dim=1)
            return cn.decode_logits(model, seq, cn.encode(model, feats))[:, len(c_prompt) - 1:]
        start = torch.full((x.shape[0], 1), mcfg.decoder_start)
        return ms.decode_logits(model, torch.cat([start, toks[:, :-1]], dim=1),
                                ms.encode(model, x))

    # the call whose returns hold each engine's decisions
    deciders = {"gigaam-v3-e2e-ctc": (pk, "ctc_logits"), "canary-180m-flash": (cn, "greedy_decode"),
                "moonshine-base": (ms, "greedy_decode"), "sense-voice-int8": (sv, "ctc_logits")}
    x = asr_chunks(rng, ASR_BATCH)
    xc = torch.from_numpy(x).cuda()
    for mid, (init, config, pieces, types) in families.items():
        t0 = time.perf_counter()
        params = init()
        n_params = sum(v.size for v in params.values())
        write_bundle(mm.model_path(mid), params, config, pieces, types)
        del params
        eng = tr.load_engine(mid, mm)  # default device: the card
        cpu = tr.load_engine(mid, mm, device="cpu")
        t1 = time.perf_counter()
        module, fn = deciders[mid]
        ctc = fn == "ctc_logits"
        with recorded(module, fn) as card_out:
            rtf, texts = engine_rtf(torch, eng, xc)
        t2 = time.perf_counter()
        with recorded(module, fn) as cpu_out:
            want = cpu.transcribe_batch(x)
        # every row's decisions: CTC frame argmax, or the greedy token ids
        # (control ids and the eos run after a row ends included) and lengths
        if ctc:
            ids_c, ids_h = card_out[-1].argmax(-1).cpu().numpy(), cpu_out[-1].argmax(-1).numpy()
            n_c = n_h = np.zeros(ASR_BATCH)
        else:
            (ids_c, n_c), (ids_h, n_h) = ((a.cpu().numpy(), n.cpu().numpy())
                                          for a, n in (card_out[-1], cpu_out[-1]))
        same = np.array_equal(ids_c, ids_h)
        if not same:  # each row's differing decision must be a near-tie
            lg_h = cpu_out[-1] if ctc else forced_logits(
                cpu.model, mid, torch.from_numpy(x), torch.from_numpy(ids_h))
            check_picks(ties, mid, ids_c, ids_h, lg_h.numpy(), independent=ctc)
        elif not np.array_equal(n_c, n_h) or texts != want:
            fail(f"{mid}: lengths or texts differ card vs CPU though every decision agrees")
        what = ("frame argmax" if ctc else f"token ids and lengths (n = {n_h.tolist()})")
        print(f"[10c] {mid}: {n_params / 1e6:.1f} M random weights (seed 0), bundle and two "
              f"load_engine calls {t1 - t0:.1f} s; card vs CPU on all {ASR_BATCH} chunks: "
              f"{what} {list(ids_h.shape)} equal {same}, texts equal {texts == want} (text "
              f"lengths {[len(t) for t in want]}; CPU path {time.perf_counter() - t2:.1f} s); "
              f"B={ASR_BATCH} x 30 s transcribe_batch host to host RTF {rtf:.4e} (two calls "
              f"{t2 - t1:.1f} s) [{card}]")
        del card_out, cpu_out
        if mid in ("canary-180m-flash", "moonshine-base"):
            decode_loop_profile(torch, mid, eng.model, xc, c_prompt)
        if len(texts) != ASR_BATCH or not all(isinstance(t, str) for t in texts):
            fail(f"{mid}: bad engine output")
        del eng, cpu
    print(f"[10c] widths: gigaam {giga}; canary {asdict(ccfg)}; moonshine {asdict(mcfg)}; "
          f"sensevoice {asdict(scfg)}")


# ---------------------------------------------------------------------------
# Phase 11: speaker diarization
# ---------------------------------------------------------------------------

class CudaStages:
    """Device time of named stages by CUDA events: ``wrap`` makes each call
    of a module function record an event pair under a name, ``time`` does
    so for a block; ``ms()`` sums them by name. Every wrapped function is
    restored on exit."""

    def __init__(self, torch):
        self.torch, self.pairs, self.saved = torch, {}, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)

    @contextlib.contextmanager
    def time(self, name: str):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        self.pairs.setdefault(name, []).append(ev)

    def wrap(self, module, attr: str, name: str) -> None:
        fn = getattr(module, attr)

        def timed(*args, **kwargs):
            with self.time(name):
                return fn(*args, **kwargs)

        self.saved.append((module, attr, fn))
        setattr(module, attr, timed)

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {name: round(sum(a.elapsed_time(b) for a, b in evs), 3)
                for name, evs in self.pairs.items()}


def speaker_segments(result) -> list:
    return [(s.start, s.end, s.speaker) for s in result]


def timed_runs(torch, fn, runs: int):
    """fn() runs times on the card, each ended by a synchronise: walls in
    seconds (host clock), the last result, and the peak device memory of
    the runs in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, out, torch.cuda.max_memory_allocated() / 1e9


def walls_line(walls, seconds: float) -> str:
    med = float(np.median(walls))
    spread = (max(walls) - min(walls)) / med
    return (f"wall {', '.join(f'{w:.3f}' for w in walls)} s (median {med:.3f} s, spread "
            f"{100 * spread:.1f}%), {seconds / med:.1f}x realtime")


def builtin_hour(torch, td, tn, dd, dev, audio, card: str):
    """Phase 11a: the built-in stand-in nets on the hour through ``diarize``
    on the card (the one-upload route), held against the port's CPU path;
    then a 60 s clip (the host-VAD route)."""
    sr = td.SAMPLE_RATE
    seconds = audio.shape[0] / sr
    td.diarize(audio[: 3 * 60 * sr], max_speakers=8, merge_gap=1.0)  # cuFFT plans, cuSOLVER
    walls, out, peak = timed_runs(
        torch, lambda: td.diarize(audio, max_speakers=8, merge_gap=1.0), DIAR_RUNS)
    with CudaStages(torch) as st, recorded(td, "_diarize_fused_frontend") as front:
        st.wrap(td, "_upload_i16", "upload and quantize")
        st.wrap(dd, "segmentation_margins", "margins")
        st.wrap(dd, "chunk_stats", "chunk stats")
        st.wrap(tn, "_graph", "NME affinity and sweep")
        st.wrap(tn, "_sweep", "NME affinity and sweep")
        st.wrap(tn, "_final", "final eigensolve and k-means")
        staged = td.diarize(audio, max_speakers=8, merge_gap=1.0)
        stages = st.ms()
    segments, chunks, emb = front[0]
    n = len(chunks)
    N = tn._bucket(n)
    print(f"[11a] diarize of {seconds:.0f} s (synth_speaker_hour, 3 tone speakers) on the card, "
          f"built-in nets, one-upload route: {walls_line(walls, seconds)}; peak device memory "
          f"{peak:.3f} GB [{card}]")
    print(f"[11a] {dd.pad_length(audio.shape[0]) // dd.WINDOW_SAMPLES} windows, "
          f"{len(segments)} speech segments, {n} chunks, embeddings {emb.shape}; NME-SC at "
          f"n={n}: bucket N={N}, P={tn._p_cap(N)}, subspace sweep "
          f"{tn._use_subspace(N, min(8, n - 1))}; {len(staged)} speaker segments, "
          f"{len({s.speaker for s in staged})} speakers")
    print(f"[11a] stages of one more call by CUDA events (ms): {stages} [{card}]")
    if speaker_segments(staged) != speaker_segments(out):
        fail("two diarize calls on the card disagree")
    prof = profile_call(torch, lambda: tn.nme_sc_device(emb, 8))
    print(f"[11a] NME-SC of the {n} embeddings under torch.profiler: {prof['launches']} "
          f"launches, {prof['device_ms']:.3f} ms of device time in {prof['wall_ms']:.3f} ms "
          f"(busy {100 * prof['busy_share']:.1f}%); top kernels (name, ms, count) "
          f"{prof['top']} [{card}]")

    # the port's CPU path on the same hour
    t0 = time.perf_counter()
    cpu = td.diarize(audio, max_speakers=8, merge_gap=1.0, device="cpu")
    t_cpu = time.perf_counter() - t0
    q, pad_to = td._upload_i16(audio, dev)
    m_card = dd.segmentation_margins(q, pad_to)
    m_cpu = dd.segmentation_margins(q.cpu(), pad_to)
    near = np.abs(m_cpu) < MARGIN_TIE
    flips = (m_card >= 0) != (m_cpu >= 0)
    print(f"[11a] vs the port's CPU path ({t_cpu:.1f} s there): margins max|diff| "
          f"{float(np.abs(m_card - m_cpu).max()):.3e}; {int(near.sum())} of {near.size} frames "
          f"within {MARGIN_TIE} of 0, {int(flips.sum())} speech decisions differ "
          f"({int((flips & ~near).sum())} off a near-zero margin)")
    if (flips & ~near).any():
        fail("a speech decision differs card vs CPU off a near-zero margin")
    if not flips.any() and speaker_segments(out) != speaker_segments(cpu):
        fail("the hour's speaker segments differ card vs CPU")
    print(f"[11a] speaker segments card vs CPU: {'equal' if not flips.any() else 'not held'} "
          f"({len(cpu)} on the CPU path)")

    clip = audio[: DIAR_CLIP_SECONDS * sr]
    with recorded(td, "_diarize_fused_frontend") as front:
        walls_c, got, _ = timed_runs(torch, lambda: td.diarize(clip, max_speakers=8), DIAR_RUNS)
    want = td.diarize(clip, max_speakers=8, device="cpu")
    print(f"[11a] {DIAR_CLIP_SECONDS} s clip, host-VAD route (one-upload route taken "
          f"{len(front)} times): {walls_line(walls_c, DIAR_CLIP_SECONDS)}; {len(got)} speaker "
          f"segments, equal to the CPU path's: {speaker_segments(got) == speaker_segments(want)}")
    if front or speaker_segments(got) != speaker_segments(want) or not got:
        fail("the 60 s clip's speaker segments differ card vs CPU")
    return chunks


class StagedSegmentation:
    """PyanNet composed as the JAX package's bench composes it: the net's
    logits enter at weight 0 (every FLOP runs and stays in the data flow),
    the decisions come from the energy-VAD margins."""

    def __init__(self, net, dd, st, stage: str = "segmentation forward"):
        self.net, self.dd, self.st, self.stage = net, dd, st, stage

    def from_device(self, q, mesh=None):
        with self.st.time(self.stage):
            real = self.net.from_device(q, mesh=mesh)
        if not np.isfinite(real).all():
            fail("non-finite segmentation logits")
        m = self.dd.segmentation_margins(q, int(q.shape[0]), mesh)
        ev = np.stack([-m, m], axis=-1)
        f = min(real.shape[1], ev.shape[1])
        return ev[:, :f] + 0.0 * real[:, :f, :2]


class StagedEmbedding:
    """CAM++ composed the same way: its embeddings at weight 0 beside the
    stand-in's chunk statistics, tiled to the embedding width."""

    def __init__(self, net, dd, st, stage: str = "CAM++ forward"):
        self.net, self.dd, self.st, self.stage = net, dd, st, stage

    def from_device(self, q, ranges, mesh=None):
        with self.st.time(self.stage):
            real = self.net.from_device(q, ranges, mesh=mesh)
        if not np.isfinite(real).all():
            fail("non-finite CAM++ embeddings")
        stand = self.dd.chunk_stats(q, int(q.shape[0]), list(ranges), mesh)
        reps = -(-real.shape[1] // stand.shape[1])
        return np.tile(stand, (1, reps))[:, : real.shape[1]] + 0.0 * real


def staged_hour(torch, td, dd, dev, audio, chunks, card: str):
    """Phase 11b: PyanNet segmentation-3.0 and CAM++ wespeaker-voxceleb at
    their published widths (the JAX layout's init_random at seed 0 through
    the carry), card against CPU, then the hour through the from_device
    route."""
    from crispy_tpu_torch.dsp.fbank import fbank
    from crispy_tpu_torch.models import campplus as tc
    from crispy_tpu_torch.models import segmentation as ts

    sr = td.SAMPLE_RATE
    seconds = audio.shape[0] / sr
    t0 = time.perf_counter()
    seg_p, cam_cfg = ts.init_random(seed=0), tc.CONFIGS["wespeaker-voxceleb"]
    cam_p = tc.init_random(cam_cfg, seed=0)
    seg, seg_cpu = ts.params_to_module(seg_p), ts.params_to_module(seg_p, device="cpu")
    cam, cam_cpu = tc.params_to_module(cam_p, cam_cfg), tc.params_to_module(cam_p, cam_cfg, "cpu")
    n_seg = sum(p.numel() for p in seg.parameters())
    n_cam = sum(p.numel() for p in cam.parameters())
    windows = audio[: 2 * ts.WINDOW_SAMPLES].reshape(2, -1)
    lc, lh = seg(windows), seg_cpu(windows)
    # CAM++ on the same fbank features on both devices (the CPU's): the
    # log-mel of pure tones is f32 rounding noise in the bins far from the
    # tone, so features made on each device differ there by up to ~0.6,
    # which moves the embeddings by ~3e-4 of their max; that difference
    # is printed, the net is held on identical inputs
    rows, n_valid = tc.chunk_rows([c.samples for c in chunks[:16]])
    feats = fbank(torch.from_numpy(rows), cam_cfg.feat_dim)[:, : tc._MAX_FRAMES]
    nv = torch.from_numpy(n_valid)
    ec = cam.forward(feats.to(dev), nv.to(dev)).cpu().numpy()
    eh = cam_cpu.forward(feats, nv).numpy()
    feats_card = fbank(torch.from_numpy(rows).to(dev), cam_cfg.feat_dim)[:, : tc._MAX_FRAMES]
    f_diff = (feats_card.cpu() - feats).abs()
    ea = cam.forward(feats_card, nv.to(dev)).cpu().numpy()
    l_err = float(np.abs(lc - lh).max() / np.abs(lh).max())
    e_err = float(np.abs(ec - eh).max() / np.abs(eh).max())
    a_err = float(np.abs(ea - eh).max() / np.abs(eh).max())
    print(f"[11b] PyanNet {n_seg / 1e6:.3f} M and CAM++ {n_cam / 1e6:.3f} M random weights "
          f"(seed 0) on the card and the CPU ({time.perf_counter() - t0:.1f} s): logits of 2 "
          f"windows {lc.shape} max|diff| {l_err:.3e} of their max, embeddings of 16 chunks "
          f"{ec.shape} from the same features {e_err:.3e} of their max (tol {NET_RTOL}); from "
          f"each device's own fbank {a_err:.3e} (features max|diff| "
          f"{float(f_diff.max()):.3e}, {float((f_diff > 1e-2).double().mean()):.4f} of them "
          f"beyond 1e-2)")
    if not (l_err <= NET_RTOL and e_err <= NET_RTOL):
        fail("a diarization net differs card vs CPU")

    with CudaStages(torch) as st:
        nets = dict(segmentation_fn=StagedSegmentation(seg, dd, st),
                    embedding_fn=StagedEmbedding(cam, dd, st))
        head = audio[: STAGED_CHECK_SECONDS * sr]
        got = td.diarize(head, max_speakers=8, merge_gap=1.0, **nets)
        want = td.diarize(head, max_speakers=8, merge_gap=1.0, device="cpu",
                          segmentation_fn=StagedSegmentation(seg_cpu, dd, st),
                          embedding_fn=StagedEmbedding(cam_cpu, dd, st))
        print(f"[11b] first {STAGED_CHECK_SECONDS} s through the from_device route: "
              f"{len(got)} speaker segments, equal to the CPU path's: "
              f"{speaker_segments(got) == speaker_segments(want)}")
        if not got or speaker_segments(got) != speaker_segments(want):
            fail("the staged nets' speaker segments differ card vs CPU")
        st.ms()
        st.pairs.clear()
        st.wrap(td, "nme_sc", "NME-SC")
        walls, out, peak = timed_runs(
            torch, lambda: td.diarize(audio, max_speakers=8, merge_gap=1.0, **nets), DIAR_RUNS)
        stages = {k: round(v / DIAR_RUNS, 3) for k, v in st.ms().items()}
    print(f"[11b] diarize of {seconds:.0f} s on the card with the staged nets: "
          f"{walls_line(walls, seconds)}; peak device memory {peak:.3f} GB; {len(out)} speaker "
          f"segments [{card}]")
    print(f"[11b] stages by CUDA events, ms a call (mean of {DIAR_RUNS}): {stages} [{card}]")
    return seg, cam


def diarized_transcription(torch, td, wav: Path, manager, card: str) -> None:
    """Phase 11c: the phase-8 WAV through run_transcription with diarization
    and the phase-6 whisper file, against a separate diarize of the same
    16 kHz audio on the card."""
    import re

    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.dsp.resample import resample_poly
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.io import wav as wavio

    bus = EventBus()
    bus.keep_history = True
    tm = tr.TranscriptionManager(manager, bus=bus)
    with recorded(td, "diarize") as calls:
        t0 = time.perf_counter()
        text = tr.run_transcription(str(wav), tm, manager.info.id, diarization={"enabled": True})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = tm.get_state(str(wav))
    falls = [p for e, p in bus.history if e == "diarization-fallback"]
    phases = [p["phase"] for e, p in bus.history if e == "transcription-phase"]
    tags = re.findall(r"\[(Speaker \d+)\|", text or "")
    audio, sr = wavio.read_wav_mono(wav)
    sep = td.diarize(resample_poly(audio, sr, 16000, wire="i16", device_out=True))
    print(f"[11c] run_transcription with diarization of the {E2E_SECONDS} s phase-8 WAV: status "
          f"{st.status if st else None}, wall {wall:.3f} s (model load included), phases "
          f"{phases}, {len(tags)} speaker tags ({sorted(set(tags))}), {len(text or '')} "
          f"characters, fallback events {falls}; its speaker segments {len(calls[0]) if calls else None}, "
          f"equal to a separate diarize on the card: "
          f"{bool(calls) and speaker_segments(calls[0]) == speaker_segments(sep)} [{card}]")
    if st is None or st.status != "completed" or falls:
        fail(f"run_transcription with diarization ended in {st} with fallbacks {falls}")
    if not tags:
        fail("the diarized transcript carries no speaker tags")
    if len(calls) != 1 or speaker_segments(calls[0]) != speaker_segments(sep):
        fail("the transcript's speaker segments differ from a separate diarize")


def diarization_phase(torch, dev, card: str, wav: Path, manager) -> dict:
    """Phase 11; returns the hour and [11b]'s nets on the card (phase 16d)."""
    from crispy_tpu_torch.engine import diar_device as dd
    from crispy_tpu_torch.engine import diarization as td
    from crispy_tpu_torch.engine import nme_device as tn
    from crispy_tpu_torch.utils.synth import synth_speaker_hour

    t0 = time.perf_counter()
    audio = synth_speaker_hour(DIAR_MINUTES)
    print(f"[11] synth_speaker_hour({DIAR_MINUTES}): {audio.shape[0]} samples "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    with torch.no_grad():
        t1 = time.perf_counter()
        chunks = builtin_hour(torch, td, tn, dd, dev, audio, card)
        t2 = time.perf_counter()
        seg, cam = staged_hour(torch, td, dd, dev, audio, chunks, card)
        t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as data:
        os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
        diarized_transcription(torch, td, wav, manager, card)
    print(f"[11] 11a, 11b, 11c took {t2 - t1:.1f}, {t3 - t2:.1f}, "
          f"{time.perf_counter() - t3:.1f} s")
    return {"audio": audio, "seg": seg, "cam": cam}



# ---------------------------------------------------------------------------
# Phase 12: the ONNX executor with the catalog's int8 parakeet bundle
# ---------------------------------------------------------------------------

def bench_bundles():
    """tools/bench_bundles (it puts tests/ on sys.path itself)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_bundles as bb

    return bb


def onnx_bundle(mm, mid: str):
    """parakeet-tdt-0.6b-v3's published widths as an int8 ONNX bundle of
    random weights (tools/bench_bundles, seed 0) in the model manager's
    directory for ``mid``, with no params.npz; returns the seconds it took."""
    t0 = time.perf_counter()
    bench_bundles().make_parakeet_sized_bundle(mm.model_path(mid), seed=0, **ONNX_DIMS)
    return time.perf_counter() - t0


@contextlib.contextmanager
def first_op_output(ox, op_type: str):
    """The outputs of the first call of one executor op while the block runs
    (one list entry per call of the block's encoder)."""
    fn, out = ox._OPS[op_type], []

    def rec(node, *args):
        res = fn(node, *args)
        if not out or node.outputs == out[0][0].outputs:  # the first node's calls
            out.append((node, res))
        return res

    for name in [k for k, v in ox._OPS.items() if v is fn]:
        ox._OPS[name] = rec
    try:
        yield out
    finally:
        for name in [k for k, v in ox._OPS.items() if v is rec]:
            ox._OPS[name] = fn


def onnx_fullwidth(torch, mm, rng, card: str, mid: str):
    """[12a] the full-width int8 bundle through load_engine on the card:
    RTF at B=8 and B=16, the encoder by CUDA events (one call under CUDA's
    sync debug mode), the decode loop under torch.profiler, executor nodes
    a call, peak memory. Returns the card's engine."""
    from crispy_tpu_torch.engine import onnx_engines as oe
    from crispy_tpu_torch.engine import transcription as tr

    build_s = onnx_bundle(mm, mid)
    size = sum(p.stat().st_size for p in mm.model_path(mid).glob("*.onnx"))
    t0 = time.perf_counter()
    eng = tr.load_engine(mid, mm)  # default device: the card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if type(eng) is not oe.OnnxTdtEngine or eng.device.type != "cuda":
        fail(f"load_engine gave {type(eng).__name__} on {eng.device} for the ONNX bundle")
    n_w = sum(v.numel() for v in eng._enc_big.values()) + sum(
        v.numel() for v in eng._dec_big.values())
    print(f"[12a] {mid} as an int8 ONNX bundle (tools/bench_bundles, seed 0, "
          f"{ONNX_DIMS or 'published widths'}): {size / 1e6:.1f} MB of .onnx, "
          f"{n_w / 1e6:.1f} M weight values on the card; build {build_s:.1f} s, load_engine "
          f"on the card {load_s:.1f} s")
    x = asr_chunks(rng, 16)
    xc = torch.from_numpy(x).cuda()
    for B in (8, 16):
        xb = xc[:B]
        eng.transcribe_batch(xb)  # warm-up: uploads the static initializers once
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, texts = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            texts = eng.transcribe_batch(xb)
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        enc_ms = []
        for _ in range(3):
            ev[0].record()
            enc = eng.encoder_output(xb)
            ev[1].record()
            torch.cuda.synchronize()
            enc_ms.append(ev[0].elapsed_time(ev[1]))
        enc_nodes = dict(eng.enc.counts)
        torch.cuda.set_sync_debug_mode("error")  # any host sync in the encoder call raises
        try:
            eng.encoder_output(xb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, n, iters = eng.decode(enc)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
        iters = int(iters)
        joint_nodes = dict(eng.dec.counts)
        prof_e = profile_call(torch, lambda: eng.encoder_output(xb))
        prof = profile_call(torch, lambda: eng.decode(enc))
        audio_s = B * ASR_SECONDS
        rtf = float(np.median(walls)) / audio_s
        print(f"[12a] B={B} x 30 s: transcribe_batch host to host "
              f"{', '.join(f'{w:.3f}' for w in walls)} s, RTF {rtf:.4e} (median of 3); "
              f"encoder {', '.join(f'{m:.3f}' for m in enc_ms)} ms (CUDA events; one more "
              f"call under sync debug mode 'error': no host sync), "
              f"{enc_nodes['device']} executor nodes on the card and {enc_nodes['host']} on "
              f"the host a call; decode loop {dec_wall * 1e3:.1f} ms host wall over {iters} "
              f"iterations ({dec_wall * 1e3 / iters:.3f} ms each; {-(-iters // oe.TDT_SYNC_EVERY)} "
              f"host checks of the end), joint call {joint_nodes['device']} nodes on the card "
              f"and {joint_nodes['host']} on the host, tokens per row {n.tolist()}; peak "
              f"memory {peak / 2**30:.2f} GiB [{card}]")
        print(f"[12a] torch.profiler over one encoder call at B={B}: {prof_e['launches']} "
              f"kernel launches, device time {prof_e['device_ms']:.3f} ms, device busy "
              f"{100 * prof_e['busy_share']:.1f}% of its {prof_e['wall_ms']:.3f} ms; top kernels "
              f"{prof_e['top']}")
        print(f"[12a] torch.profiler over one decode loop at B={B}: {prof['launches']} kernel "
              f"launches = {prof['launches'] / iters:.1f} per iteration, device time "
              f"{prof['device_ms']:.3f} ms, device busy {100 * prof['busy_share']:.1f}% of its "
              f"{prof['wall_ms']:.3f} ms under the profiler; top kernels {prof['top']}")
        if len(texts) != B or not all(texts):
            fail(f"the ONNX TDT engine returned empty texts at B={B}: {texts}")
    return eng


def onnx_card_vs_cpu(torch, mm, rng, mid: str, eng, ties: list) -> None:
    """[12b] the same bundle on the card against the CPU path, B=2 x 10 s:
    the first layer's DynamicQuantizeLinear codes, its MatMulInteger on
    identical codes (bit-equal), the encoder output, and every token and
    duration decision of the decode loop on the card's encoder output."""
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models import onnx_exec as ox

    t0 = time.perf_counter()
    cpu = tr.load_engine(mid, mm, device="cpu")
    x = np.stack([speechlike(ONNX_CHECK_SECONDS * 16000, rng, 105.0 + 40.0 * b, sr=16000)
                  for b in range(2)])
    with first_op_output(ox, "DynamicQuantizeLinear") as dq:
        enc_c = eng.encoder_output(torch.from_numpy(x).cuda())
        enc_h = cpu.encoder_output(x)
    (node, (q_c, s_c, z_c)), (_, (q_h, s_h, z_h)) = dq[0], dq[1]
    n_codes = int((q_c.cpu() != q_h).sum())
    # the first MatMulInteger of the graph on the CPU's codes, on both devices
    mmi = next(n for n in eng.enc.graph.nodes if n.op_type == "MatMulInteger")
    w = eng.enc.graph.initializers[mmi.inputs[1]]
    wz = eng.enc.graph.initializers[mmi.inputs[3]]
    y_h = ox._mmi(mmi, q_h, torch.from_numpy(w.copy()), z_h, torch.from_numpy(wz.copy()))
    y_c = ox._mmi(mmi, q_h.cuda(), torch.from_numpy(w.copy()).cuda(), z_h.cuda(),
                  torch.from_numpy(wz.copy()).cuda())
    mmi_equal = torch.equal(y_c.cpu(), y_h)
    enc_err = rel_err(enc_c, enc_h)
    # the decode loops on the card's encoder output: card against CPU (the
    # CPU engine's probe call first, so that both records start at step 0)
    cpu._pin_heads(enc_c.shape[0], enc_c.shape[2])
    with recorded(eng, "_joint") as steps_c:
        toks_c, times_c, n_c, it_c = eng.decode(enc_c)
    with recorded(cpu, "_joint") as steps_h:
        toks_h, times_h, n_h, it_h = cpu.decode(enc_c.cpu())
    V = eng.vocab_size
    diverged, worst = None, 0.0
    for i, ((lc, _), (lh, _)) in enumerate(zip(steps_c, steps_h)):
        lc, lh = lc.cpu().numpy(), lh.numpy()
        for head, sl in (("token", slice(0, V + 1)), ("duration", slice(V + 1, None))):
            pc, ph = lc[:, sl].argmax(-1), lh[:, sl].argmax(-1)
            for b in np.nonzero(pc != ph)[0]:
                near_tie(ties, mid, f"row {b} iteration {i} ({head})", lh[b, sl], int(pc[b]),
                         int(ph[b]), tol=INT8_TIE_RTOL)
                diverged = i
        if diverged is not None:
            break
        worst = max(worst, float(np.abs(lc - lh).max() / np.abs(lh).max()))
    same = (torch.equal(toks_c.cpu(), toks_h) and torch.equal(times_c.cpu(), times_h)
            and torch.equal(n_c.cpu(), n_h))
    print(f"[12b] card vs CPU on B=2 x {ONNX_CHECK_SECONDS} s ({time.perf_counter() - t0:.1f} s, "
          f"the CPU engine's load included): first DynamicQuantizeLinear (to "
          f"{node.outputs[0]}) codes differing {n_codes} of {q_h.numel()}, scale "
          f"{float(s_c):.9g} vs {float(s_h):.9g}, "
          f"zero point {int(z_c)} vs {int(z_h)}; its MatMulInteger (to {mmi.outputs[0]}, "
          f"{list(q_h.shape)} x {list(w.shape)}) on the CPU's codes bit-equal card vs CPU: "
          f"{mmi_equal}; encoder output max|diff| {enc_err:.3e} of its largest magnitude (tol "
          f"{ENC_INT8_RTOL}); decode loop on the card's encoder output: {int(it_c)} iterations "
          f"on the card, {int(it_h)} on the CPU, joint logits within {worst:.3e} of their "
          f"largest magnitude on the agreeing steps, first divergent decision at {diverged}, "
          f"tokens, times and counts equal {same} (n = {n_h.tolist()})")
    if not mmi_equal:
        fail("MatMulInteger differs card vs CPU on identical codes")
    if not enc_err <= ENC_INT8_RTOL:
        fail(f"the ONNX encoder output differs card vs CPU by {enc_err}")
    if diverged is None and not same:
        fail("ONNX TDT tokens differ card vs CPU with no divergent decision")


def onnx_run_transcription(torch, mm, mid: str, eng, wav: Path, card: str) -> None:
    """[12c] the phase-8 WAV (5 min, 48 kHz) through run_transcription and
    the engine of [12a]: ten chunks in one 16-bucket."""
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import transcription as tr

    bus = EventBus()
    bus.keep_history = True
    seen = []
    inner = eng.transcribe_batch

    def recording(chunks, language="en"):
        seen.append((type(chunks).__name__, str(getattr(chunks, "device", "host")),
                     tuple(chunks.shape)))
        return inner(chunks, language=language)

    eng.transcribe_batch = recording
    tm = tr.TranscriptionManager(mm, bus=bus, engine_loader=lambda model_id, m: eng)
    try:
        t0 = time.perf_counter()
        text = tr.run_transcription(str(wav), tm, mid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng.transcribe_batch
    st = tm.get_state(str(wav))
    stages = [(p["stage"], round(p["seconds"], 4), p.get("chunks"))
              for e, p in bus.history if e == "stage-timing"]
    print(f"[12c] run_transcription of the phase-8 WAV ({E2E_SECONDS} s, 48 kHz) through the "
          f"engine of [12a]: status {st.status if st else None}, wall {wall:.3f} s, RTF "
          f"{wall / E2E_SECONDS:.3e} (the model loaded before), chunk batches {seen}, stages "
          f"{stages}, {len(text or '')} characters [{card}]")
    if st is None or st.status != "completed" or not text:
        fail(f"the ONNX run_transcription ended in {st}")
    if seen != [("Tensor", "cuda:0", (16, 30 * 16000))]:
        fail(f"expected one 16-chunk bucket on the card: {seen}")


def onnx_layouts(torch, rng) -> None:
    """[12d] the gigaam and sensevoice CTC layouts and the small parakeet TDT
    layout of the JAX package's engine tests through load_engine, card
    against CPU (equal texts); one ConvInteger graph and one Loop graph with
    a condition computed on the device, card against CPU (equal outputs)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import onnx_builder as ob
    import test_onnx_engines as layouts

    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models import onnx_exec as ox
    from crispy_tpu_torch.models.registry import ModelManager

    x = np.stack([speechlike(3 * 16000, rng, 100.0 + 50.0 * b, sr=16000) for b in range(4)])
    with tempfile.TemporaryDirectory() as tmp:
        mm = ModelManager(models_dir=Path(tmp) / "Models")
        results = {}
        for mid, make in (("gigaam-v3-e2e-ctc", layouts.make_gigaam_bundle),
                          ("sense-voice-int8", layouts.make_sensevoice_bundle),
                          ("parakeet-tdt-0.6b-v2", layouts.make_parakeet_bundle)):
            mm.model_path(mid).mkdir(parents=True)
            make(mm.model_path(mid))
            card_eng = tr.load_engine(mid, mm)  # default device: the card
            cpu_eng = tr.load_engine(mid, mm, device="cpu")
            got, want = card_eng.transcribe_batch(x), cpu_eng.transcribe_batch(x)
            segs = (card_eng.transcribe_batch_with_timestamps(x, [0.0] * 4),
                    cpu_eng.transcribe_batch_with_timestamps(x, [0.0] * 4))
            results[mid] = (type(card_eng).__name__, got == want, segs[0] == segs[1])
            if got != want or segs[0] != segs[1]:
                fail(f"{mid} layout: card {got} vs CPU {want}")
        g = np.random.default_rng(SEED + 7)
        xi = g.integers(0, 256, (2, 6, 40), dtype=np.uint8)
        w = g.integers(-128, 128, (8, 3, 5), dtype=np.int8)
        conv = ob.model_proto([ob.node("ConvInteger", ["x", "w", "xz", "wz"], ["y"], group=2,
                                       strides=[2], pads=[2, 1])],
                              [("x", 2, [2, 6, 40])], [("y", 6, None)],
                              {"w": w, "xz": np.uint8(131), "wz": np.int8(-2)})
        body = ob.graph_proto(
            [ob.node("Mul", ["acc_in", "two"], ["acc_out"]),
             ob.node("ReduceMax", ["acc_out"], ["a0"], keepdims=0),
             ob.node("Less", ["a0", "limit"], ["cond_out"]),
             ob.node("Identity", ["acc_out"], ["snap"])],
            [("iter", 7, []), ("cond_in", 9, []), ("acc_in", 1, [3])],
            [("cond_out", 9, []), ("acc_out", 1, [3]), ("snap", 1, [3])],
            {"two": np.full(3, 2.0, np.float32)})
        loop = ob.model_proto([ob.node("Loop", ["M", "cond", "acc0"], ["acc", "snaps"],
                                       body=body)],
                              [("acc0", 1, [3]), ("limit", 1, [])],
                              [("acc", 1, [3]), ("snaps", 1, [None, 3])],
                              {"M": np.int64(40), "cond": np.array(True)})
        graphs = {}
        for name, data, inputs in (
                ("ConvInteger", conv, {"x": xi}),
                ("Loop", loop, {"acc0": np.array([0.5, 1.0, 0.25], np.float32),
                                "limit": np.array(1000.0, np.float32)})):
            path = Path(tmp) / f"{name}.onnx"
            path.write_bytes(data)
            r = ox.OnnxRunner.load(path).validate()
            on_card = r(**{k: torch.from_numpy(v).cuda() for k, v in inputs.items()})
            on_cpu = r(**{k: torch.from_numpy(v) for k, v in inputs.items()})
            equal = all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in on_cpu)
            graphs[name] = (equal, {k: list(v.shape) for k, v in on_cpu.items()},
                            str(next(iter(on_card.values())).device))
            if not equal:
                fail(f"the {name} graph differs card vs CPU")
    print(f"[12d] layouts through load_engine, card vs CPU (engine, texts equal, word segments "
          f"equal): {results}; graphs card vs CPU (outputs equal, shapes, device): {graphs}")


def onnx_phase(torch, card: str, wav: Path, keep: contextlib.ExitStack):
    """Phase 12; the bundle's directory stays until ``keep`` closes, and the
    card's engine is returned with its model manager and id (phase 16c)."""
    from crispy_tpu_torch.models.registry import ModelManager

    t0 = time.perf_counter()
    ties: list = []
    orng = np.random.default_rng(SEED + 6)
    mid = "parakeet-tdt-0.6b-v3"
    tmp = keep.enter_context(tempfile.TemporaryDirectory())
    with tempfile.TemporaryDirectory() as data:
        os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
        mm = ModelManager(models_dir=Path(tmp) / "Models")
        with torch.no_grad():
            eng = onnx_fullwidth(torch, mm, orng, card, mid)
            t1 = time.perf_counter()
            onnx_card_vs_cpu(torch, mm, orng, mid, eng, ties)
            t2 = time.perf_counter()
            onnx_run_transcription(torch, mm, mid, eng, wav, card)
            t3 = time.perf_counter()
        onnx_layouts(torch, orng)
    print(f"[12] decisions that differ card vs CPU at a near-tie: {len(ties)} {ties}; 12a, 12b, "
          f"12c, 12d took {t1 - t0:.1f}, {t2 - t1:.1f}, {t3 - t2:.1f}, "
          f"{time.perf_counter() - t3:.1f} s")
    return mm, mid, eng


# ---------------------------------------------------------------------------
# Phase 13: the catalog's encoder-decoder ONNX bundles and the executor's
# diarization nets
# ---------------------------------------------------------------------------

def canary_decoder(path: Path, D: int, L: int, FF: int, HEADS: int, V: int, eos: int,
                   max_len: int = 512, pos_scale: float = 8.0, seed: int = 1) -> None:
    """An uncached canary-style decoder graph with int8 products (the ort
    quantize_dynamic pattern of tools/bench_bundles): input_ids [B, S] and the
    encoder's [B, D, T'] → logits [B, S, V]. Token embedding plus sinusoidal
    positions, L pre-LN layers of causal self-attention over the full prefix,
    cross-attention over the transposed encoder output and a ReLU FFN, a final
    LN and the vocabulary product, whose eos column is zero: eos never wins,
    so every row decodes to max_new (the worst case) unless the engine's
    degenerate-loop guard ends it. With random weights (from ``seed``) and
    unit positions the next token follows the last one and falls into a
    fixed point within ~10 tokens, which the guard cuts; positions at 8x
    make each step's token depend on its position, so rows run to max_new
    ([13a] prints the tokens each row generated)."""
    bb = bench_bundles()
    import onnx_builder as ob

    rng = np.random.default_rng(seed)
    DH = D // HEADS
    ang = np.arange(max_len)[:, None] / np.power(10000.0, np.arange(0, D, 2)[None, :] / D)
    table = np.zeros((max_len, D), np.float32)
    table[:, 0::2], table[:, 1::2] = np.sin(ang), np.cos(ang)
    inits = {"emb": rng.standard_normal((V, D)).astype(np.float32), "pos": pos_scale * table,
             "mask": np.triu(np.full((max_len, max_len), -1e4, np.float32), 1),
             "i0": np.array([0], np.int64), "i1": np.array([1], np.int64),
             "i2": np.array([2], np.int64), "z2": np.array([0, 0], np.int64),
             "ax01": np.array([0, 1], np.int64),
             "hd": np.array([0, 0, HEADS, DH], np.int64), "flat": np.array([0, 0, D], np.int64),
             "scale": np.float32(1.0 / np.sqrt(DH))}
    nodes = [
        ob.node("Shape", ["input_ids"], ["ids_sh"]),
        ob.node("Slice", ["ids_sh", "i1", "i2"], ["S1"]),
        ob.node("Concat", ["S1", "S1"], ["SS"], axis=0),
        ob.node("Gather", ["emb", "input_ids"], ["te"], axis=0),
        ob.node("Slice", ["pos", "i0", "S1", "i0"], ["pe"]),
        ob.node("Add", ["te", "pe"], ["x0"]),
        ob.node("Slice", ["mask", "z2", "SS", "ax01"], ["cm"]),
        ob.node("Transpose", ["encoder_states"], ["encT"], perm=[0, 2, 1]),
    ]

    def qmm(tag, x_in, shape, out, zero_col=None):
        w, s = bb._int8_w(rng, shape)
        if zero_col is not None:
            w[:, zero_col] = 0
        n, i = bb._qmatmul(tag, x_in, w, s, out)
        nodes.extend(n)
        inits.update(i)

    def ln(tag, x_in, out):
        inits[f"{tag}_g"] = (rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
        inits[f"{tag}_b"] = np.zeros(D, np.float32)
        nodes.extend(bb._ln(tag, x_in, f"{tag}_g", f"{tag}_b", out))

    def heads(tag, x_in, out, perm):
        nodes.extend([ob.node("Reshape", [x_in, "hd"], [f"{tag}4"]),
                      ob.node("Transpose", [f"{tag}4"], [out], perm=perm)])

    def attention(p, q_in, kv_in, mask, out):
        """Multi-head attention of q_in over kv_in, projected: out."""
        qmm(f"{p}q", q_in, (D, D), f"{p}qf")
        qmm(f"{p}k", kv_in, (D, D), f"{p}kf")
        qmm(f"{p}v", kv_in, (D, D), f"{p}vf")
        heads(f"{p}q", f"{p}qf", f"{p}qh", [0, 2, 1, 3])  # [B, H, S, DH]
        heads(f"{p}k", f"{p}kf", f"{p}kT", [0, 2, 3, 1])  # [B, H, DH, T]
        heads(f"{p}v", f"{p}vf", f"{p}vh", [0, 2, 1, 3])
        nodes.extend([ob.node("MatMul", [f"{p}qh", f"{p}kT"], [f"{p}s0"]),
                      ob.node("Mul", [f"{p}s0", "scale"], [f"{p}s1"])])
        sc = f"{p}s1"
        if mask is not None:
            nodes.append(ob.node("Add", [sc, mask], [f"{p}s2"]))
            sc = f"{p}s2"
        nodes.extend([ob.node("Softmax", [sc], [f"{p}aw"], axis=-1),
                      ob.node("MatMul", [f"{p}aw", f"{p}vh"], [f"{p}ctx"]),
                      ob.node("Transpose", [f"{p}ctx"], [f"{p}ctxt"], perm=[0, 2, 1, 3]),
                      ob.node("Reshape", [f"{p}ctxt", "flat"], [f"{p}ctxf"])])
        qmm(f"{p}o", f"{p}ctxf", (D, D), out)

    x = "x0"
    for li in range(L):
        p = f"d{li}"
        ln(f"{p}sa", x, f"{p}san")
        attention(f"{p}sa_", f"{p}san", f"{p}san", "cm", f"{p}sao")
        nodes.append(ob.node("Add", [x, f"{p}sao"], [f"{p}x1"]))
        ln(f"{p}ca", f"{p}x1", f"{p}can")
        attention(f"{p}ca_", f"{p}can", "encT", None, f"{p}cao")
        nodes.append(ob.node("Add", [f"{p}x1", f"{p}cao"], [f"{p}x2"]))
        ln(f"{p}ff", f"{p}x2", f"{p}ffn")
        qmm(f"{p}f1", f"{p}ffn", (D, FF), f"{p}fh")
        nodes.append(ob.node("Relu", [f"{p}fh"], [f"{p}fr"]))
        qmm(f"{p}f2", f"{p}fr", (FF, D), f"{p}fo")
        nodes.append(ob.node("Add", [f"{p}x2", f"{p}fo"], [f"{p}x3"]))
        x = f"{p}x3"
    ln("fin", x, "xf")
    qmm("head", "xf", (D, V), "logits", zero_col=eos)
    ob.write_model(path, nodes, [("input_ids", 6, [None, None]),
                                 ("encoder_states", 1, [None, D, None])],
                   [("logits", 1, [None, None, V])], inits)


CANARY_SPECIALS = ["<unk>", "<pad>", "</s>", "<|startoftranscript|>", "<|en|>",
                   "<|transcribe|>", "<|pnc|>", "<|nopnc|>", "<s>"]


def canary_bundle(d: Path, cfg, seed: int = 0) -> Path:
    """canary's published widths (``cfg``, the port's models/canary config)
    as an int8 ONNX bundle of random weights: tools/bench_bundles' encoder,
    ``canary_decoder`` and a vocab.txt with canary's prompt tokens and </s>."""
    d.mkdir(parents=True, exist_ok=True)
    enc = cfg.encoder
    bench_bundles().make_parakeet_sized_encoder(
        d / "encoder-model.int8.onnx", D=enc.hidden_size, L=enc.layers,
        FF=enc.intermediate_size, HEADS=enc.heads, seed=seed)
    canary_decoder(d / "decoder-model.int8.onnx", D=cfg.dec_hidden, L=cfg.dec_layers,
                   FF=cfg.dec_ffn, HEADS=cfg.dec_heads, V=cfg.vocab_size,
                   eos=CANARY_SPECIALS.index("</s>"), seed=seed + 1)
    vocab = CANARY_SPECIALS + [f"▁w{i}" for i in range(cfg.vocab_size - len(CANARY_SPECIALS))]
    (d / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    return d


def generated(tokens: np.ndarray, P: int, eos: int) -> List[int]:
    """Tokens each row generated before its eos."""
    out = []
    for row in tokens:
        hits = np.nonzero(row[P:] == eos)[0]
        out.append(int(hits[0]) if hits.size else row.size - P)
    return out


def encdec_fullwidth(torch, mm, rng, card: str, mid: str):
    """[13a] the full-width int8 canary bundle through load_engine on the card:
    RTF at B=8 and B=16 on worst-case decoding, the encoder by CUDA events,
    decode steps a bucket, executor nodes and launches a step, the device's
    busy share of one bucket's loop, peak memory. Returns the engine."""
    from collections import Counter

    from crispy_tpu_torch.engine import onnx_engines as oe
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models.canary import CONFIGS

    cfg = CONFIGS[mid]
    t0 = time.perf_counter()
    path = canary_bundle(mm.model_path(mid), cfg)
    build_s = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in path.glob("*.onnx"))
    t0 = time.perf_counter()
    eng = tr.load_engine(mid, mm)  # default device: the card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if type(eng) is not oe.OnnxEncDecEngine or eng.device.type != "cuda":
        fail(f"load_engine gave {type(eng).__name__} on {eng.device} for the enc-dec bundle")
    n_w = [sum(v.size for v in r.graph.initializers.values()) for r in (eng.enc, eng.dec)]
    P = len(eng.prompt_ids)
    print(f"[13a] {mid} as an int8 ONNX bundle (tools/bench_bundles encoder, canary_decoder, "
          f"seed 0) at its published widths (encoder {cfg.encoder.layers} layers, d "
          f"{cfg.encoder.hidden_size}, {cfg.encoder.heads} heads, FFN "
          f"{cfg.encoder.intermediate_size}; decoder {cfg.dec_layers} layers, d {cfg.dec_hidden}, "
          f"{cfg.dec_heads} heads, FFN {cfg.dec_ffn}, V {cfg.vocab_size}): {n_w[0] / 1e6:.3f} M "
          f"encoder and {n_w[1] / 1e6:.3f} M decoder weight values, {size / 1e6:.1f} MB of "
          f".onnx; build {build_s:.1f} s, load_engine on the card {load_s:.1f} s; prompt "
          f"{eng.prompt_ids}, eos {eng.eos_id}, max_new {eng.max_new}, buckets "
          f"{eng._buckets(P)[1]}, host read of done every {eng.SYNC_EVERY} steps")
    xc = torch.from_numpy(asr_chunks(rng, max(ENCDEC_BATCHES))).cuda()
    for B in ENCDEC_BATCHES:
        xb = xc[:B]
        t0 = time.perf_counter()
        eng.transcribe_batch(xb)  # warm-up: uploads the static initializers once
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        walls = []
        with recorded(eng, "_decode", keep=lambda lg: int(lg.shape[1])) as lens, \
                recorded(eng, "_decode_tokens") as toks:
            for _ in range(ENCDEC_RUNS):
                t0 = time.perf_counter()
                texts = eng.transcribe_batch(xb)
                walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        steps = dict(sorted(Counter(lens[: len(lens) // ENCDEC_RUNS]).items()))
        gen = generated(toks[-1], P, eng.eos_id)
        nodes = dict(eng.dec.counts)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        enc_ms = []
        for _ in range(3):
            ev[0].record()
            enc = eng.encoder_output(xb)
            ev[1].record()
            torch.cuda.synchronize()
            enc_ms.append(ev[0].elapsed_time(ev[1]))
        enc_nodes = dict(eng.enc.counts)
        S = eng._buckets(P)[1][0]
        s0 = S - ENCDEC_PROFILE_STEPS

        def last_steps():
            toks0 = eng._prompted(B, S, eng.prompt_ids)
            toks0[:, P:s0] = torch.from_numpy(toks[-1][:, P:s0].astype(np.int32))
            done = torch.zeros(B, dtype=torch.bool, device=xb.device)
            return eng._greedy_bucket(toks0, enc, eng._dec_extra(B, S), s0, done, P)

        t0 = time.perf_counter()
        with recorded(eng, "_decode", keep=lambda lg: 0) as ran:
            prof = profile_call(torch, last_steps)
        prof_s = time.perf_counter() - t0
        n_steps = len(ran)
        rtf = float(np.median(walls)) / (B * ASR_SECONDS)
        spread = (max(walls) - min(walls)) / float(np.median(walls))
        print(f"[13a] B={B} x 30 s: transcribe_batch host to host "
              f"{', '.join(f'{w:.3f}' for w in walls)} s, RTF {rtf:.4e} (median of "
              f"{ENCDEC_RUNS}, spread {100 * spread:.1f}%; the warm-up call {warm_s:.3f} s); "
              f"decode steps by bucket length "
              f"{steps}, tokens generated per row {gen}; encoder "
              f"{', '.join(f'{m:.3f}' for m in enc_ms)} ms (CUDA events), {enc_nodes['device']} "
              f"executor nodes on the card and {enc_nodes['host']} on the host a call; decoder "
              f"{nodes['device']} nodes on the card and {nodes['host']} on the host a step; "
              f"peak memory {peak / 2**30:.2f} GiB [{card}]")
        print(f"[13a] torch.profiler over the first bucket's last {n_steps} steps at B={B} "
              f"(S={S}, the loop's own code): {prof['launches']} kernel launches = "
              f"{prof['launches'] / n_steps:.1f} a step, {prof['wall_ms'] / n_steps:.3f} ms a "
              f"step, device time {prof['device_ms']:.3f} ms, device busy "
              f"{100 * prof['busy_share']:.1f}% of its {prof['wall_ms']:.3f} ms under the "
              f"profiler ({prof_s:.1f} s with the trace's read-back); top kernels {prof['top']}")
        if len(texts) != B or not all(texts):
            fail(f"the ONNX enc-dec engine returned empty texts at B={B}: {texts}")
    return eng


def encdec_card_vs_cpu(torch, mm, rng, mid: str, eng, ties: list) -> None:
    """[13a] the same bundle on the card against the CPU path on 2 x 10 s:
    the encoder output, then greedy and beam-4 decoding (ENCDEC_CHECK_NEW
    tokens) of the card's encoder output on both devices, every decision
    equal up to the first that differs, which must be a near-tie."""
    from crispy_tpu_torch.engine import onnx_engines as oe
    from crispy_tpu_torch.engine import transcription as tr

    t0 = time.perf_counter()
    cpu = tr.load_engine(mid, mm, device="cpu")
    x = np.stack([speechlike(ONNX_CHECK_SECONDS * 16000, rng, 110.0 + 35.0 * b, sr=16000)
                  for b in range(2)])
    enc_c = eng.encoder_output(torch.from_numpy(x).cuda())
    enc_h = cpu.encoder_output(x)
    enc_err = rel_err(enc_c, enc_h)
    if not enc_err <= ENC_INT8_RTOL:
        fail(f"the ONNX canary encoder output differs card vs CPU by {enc_err}")
    P, eos = len(eng.prompt_ids), eng.eos_id
    best = {}
    saved = eng.max_new, cpu.max_new
    eng.max_new = cpu.max_new = ENCDEC_CHECK_NEW
    try:
        # greedy: every step's argmax on both devices (step i writes position
        # P + i); the first that differs on a row still running is held to
        # the CPU's logits there, recomputed on the CPU's own prefix
        picks = {}
        for name, e, enc in (("card", eng, enc_c), ("cpu", cpu, enc_c.cpu())):
            with recorded(e, "_decode", keep=lambda lg: lg.argmax(-1).cpu().numpy()) as am:
                picks[name] = (e._decode_tokens(enc, 2, e.prompt_ids, 1), am)
        (tc, am_c), (th, am_h) = picks["card"], picks["cpu"]
        first = None
        for i, (a, b) in enumerate(zip(am_c, am_h)):
            s = P + i
            live = [r for r in range(2) if eos not in th[r, P:s]]
            bad = [r for r in live if a[r, s - 1] != b[r, s - 1]]
            if not bad:
                continue
            first, S = s, b.shape[1]
            t = th[:, :S].copy()
            t[:, s:] = 0
            lg = cpu._decode(torch.from_numpy(t.astype(np.int32)), enc_c.cpu(),
                             cpu._dec_extra(2, S), cpu._dec_big)[:, s - 1].numpy()
            for r in bad:
                near_tie(ties, f"{mid} ONNX greedy", f"row {r} step {s}", lg[r],
                         int(a[r, s - 1]), int(b[r, s - 1]), tol=INT8_TIE_RTOL)
            break
        # beam 4: the top-k candidates of every step on both devices
        cands = {}
        real = oe._top_k
        for name, e, enc in (("card", eng, enc_c), ("cpu", cpu, enc_c.cpu())):
            cands[name] = steps = []

            def rec(c, k, steps=steps, keep_all=name == "cpu"):
                vals, idx = real(c, k)
                steps.append((c.numpy() if keep_all else None, idx.cpu().numpy()))
                return vals, idx

            oe._top_k = rec
            try:
                best[name] = e._decode_tokens(enc, 2, e.prompt_ids, ENCDEC_BEAM)
            finally:
                oe._top_k = real
        first_b = None
        for i, ((_, ic), (ch, ih)) in enumerate(zip(cands["card"], cands["cpu"])):
            if np.array_equal(ic, ih):
                continue
            first_b = i
            for b, j in zip(*np.nonzero(ic != ih)):
                row = ch[b][np.isfinite(ch[b])]
                ratio = float(abs(ch[b, ic[b, j]] - ch[b, ih[b, j]]) / np.abs(row).max())
                print(f"[13a] beam {ENCDEC_BEAM}: candidate {j} of row {b} differs card vs CPU "
                      f"at step {i}: card {int(ic[b, j])}, CPU {int(ih[b, j])}; their CPU scores "
                      f"differ by {ratio:.3e} of the largest |score| (passes below "
                      f"{INT8_TIE_RTOL})")
                if not ratio < INT8_TIE_RTOL:
                    fail("a beam candidate differs card vs CPU off a near-tie")
                ties.append((f"{mid} ONNX beam", f"row {b} step {i} rank {j}", ratio))
            break
        same_b = np.array_equal(best["card"], best["cpu"])
        if first_b is None and not same_b:
            fail("beam tokens differ card vs CPU with no divergent candidate")
        if first is None and not np.array_equal(tc, th):
            fail("greedy tokens differ card vs CPU with no divergent decision")
    finally:
        eng.max_new, cpu.max_new = saved
    print(f"[13a] card vs CPU on B=2 x {ONNX_CHECK_SECONDS} s ({time.perf_counter() - t0:.1f} s, "
          f"the CPU engine's load included): encoder output max|diff| {enc_err:.3e} of its "
          f"largest magnitude (tol {ENC_INT8_RTOL}); on the card's encoder output, "
          f"max_new {ENCDEC_CHECK_NEW}: greedy decisions equal at every step {first is None} "
          f"(first differing step {first}; tokens per row on the CPU {generated(th, P, eos)}), "
          f"tokens equal {np.array_equal(tc, th)}; beam "
          f"{ENCDEC_BEAM} top-k candidates equal at every step {first_b is None} (first "
          f"differing step {first_b}), best rows equal {same_b}")


@contextlib.contextmanager
def timed_op(ox, st, op_type: str, stage: str):
    """Every call of one executor op timed by CUDA events under ``stage``
    while the block runs."""
    fn = ox._OPS[op_type]

    def timed(node, *args):
        with st.time(stage):
            return fn(node, *args)

    ox._OPS[op_type] = timed
    try:
        yield
    finally:
        ox._OPS[op_type] = fn


def executor_hour(torch, dev, card: str) -> None:
    """[13b] pyannote-sized segmentation and CAM++-scale embedding graphs
    (tools/bench_bundles) through the port's onnx_nets on the diarization
    hour, composed as the JAX package's executor bench composes them; card
    against CPU; run_diarization's executor route under a stub manager."""
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import diar_device as dd
    from crispy_tpu_torch.engine import diarization as td
    from crispy_tpu_torch.models import onnx_exec as ox
    from crispy_tpu_torch.models import onnx_nets
    from crispy_tpu_torch.utils.synth import synth_speaker_hour

    bb = bench_bundles()
    sr = td.SAMPLE_RATE
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        seg_p = bb.make_pyannote_sized_segmentation(Path(tmp) / "segmentation-3.0.onnx", seed=0)
        emb_p = bb.make_campplus_scale_embedding(
            Path(tmp) / "wespeaker_en_voxceleb_CAM++.onnx", seed=1)
        n_w = [sum(v.size for v in ox.load_onnx_graph(p).initializers.values())
               for p in (seg_p, emb_p)]
        seg, emb = onnx_nets.segmentation_runner(seg_p), onnx_nets.embedding_runner(emb_p)
        seg_h = onnx_nets.segmentation_runner(seg_p, device="cpu")
        emb_h = onnx_nets.embedding_runner(emb_p, device="cpu")
        audio = synth_speaker_hour(DIAR_MINUTES)
        seconds = audio.shape[0] / sr
        windows = audio[: 2 * onnx_nets.WINDOW_SAMPLES].reshape(2, -1)
        lc, lh = seg(windows), seg_h(windows)
        g = np.random.default_rng(SEED + 8)
        chunks = [speechlike(int(g.integers(sr, 4 * sr)), g, 100.0 + 20.0 * i, sr=sr)
                  for i in range(EXEC_EMB_CHUNKS)]
        ec, eh = emb(chunks), emb_h(chunks)
        l_err = float(np.abs(lc - lh).max() / np.abs(lh).max())
        e_err = float(np.abs(ec - eh).max() / np.abs(eh).max())
        print(f"[13b] segmentation (tools/bench_bundles pyannote-sized, {n_w[0] / 1e6:.3f} M "
              f"weights) and embedding (CAM++-scale, {n_w[1] / 1e6:.3f} M) graphs, seed 0 and "
              f"1, on the card and the CPU ({time.perf_counter() - t0:.1f} s with the hour's "
              f"synthesis): logits of 2 windows {lc.shape} max|diff| {l_err:.3e} of their max, "
              f"embeddings of {EXEC_EMB_CHUNKS} speech-like chunks of 1-4 s {ec.shape} "
              f"{e_err:.3e} of their max (tol {NET_RTOL})")
        if not (l_err <= NET_RTOL and e_err <= NET_RTOL):
            fail("an executor diarization net differs card vs CPU")

        with CudaStages(torch) as st, timed_op(ox, st, "LSTM", "executor LSTM"):
            nets = dict(segmentation_fn=StagedSegmentation(seg, dd, st, "segmentation graph"),
                        embedding_fn=StagedEmbedding(emb, dd, st, "embedding graph"))
            td.diarize(audio[: STAGED_CHECK_SECONDS * sr], max_speakers=8, merge_gap=1.0,
                       **nets)  # warm-up: uploads, cuDNN plans
            st.ms()
            st.pairs.clear()
            st.wrap(td, "nme_sc", "NME-SC")
            walls, out, peak = timed_runs(
                torch, lambda: td.diarize(audio, max_speakers=8, merge_gap=1.0, **nets), DIAR_RUNS)
            stages = {k: round(v / DIAR_RUNS, 3) for k, v in st.ms().items()}
        print(f"[13b] diarize of {seconds:.0f} s on the card through the executor's nets "
              f"(composed as bench.py's bench_diarization_exec): {walls_line(walls, seconds)}; "
              f"peak device memory {peak:.3f} GB; {len(out)} speaker segments [{card}]")
        print(f"[13b] stages by CUDA events, ms a call (mean of {DIAR_RUNS}; the executor "
              f"LSTM is inside the segmentation graph): {stages} [{card}]")

        class Stub:
            def is_downloaded(self, mid):
                return mid in ("diarize-segmentation", "diarize-embedding")

            def model_path(self, mid):
                return seg_p if mid == "diarize-segmentation" else emb_p

        bus = EventBus()
        bus.keep_history = True
        clip = audio[: STAGED_CHECK_SECONDS * sr]
        with recorded(onnx_nets, "segmentation_runner", keep=lambda r: 1) as s_built, \
                recorded(onnx_nets, "embedding_runner", keep=lambda r: 1) as e_built, \
                recorded(td, "_diarize_device_nets", keep=lambda r: len(r[1])) as routed:
            t0 = time.perf_counter()
            text = td.run_diarization(clip, sr, [(0.0, 60.0, "hello"), (60.0, 150.0, "world")],
                                      model_manager=Stub(), bus=bus)
            wall = time.perf_counter() - t0
        falls = [p for e, p in bus.history if e == "diarization-fallback"]
        print(f"[13b] run_diarization of {STAGED_CHECK_SECONDS} s under a stub manager holding "
              f"both .onnx files: executor runners built {len(s_built)} + {len(e_built)}, "
              f"one-upload route with {routed} chunks, fallback events {falls}, "
              f"{len(text)} characters, wall {wall:.3f} s (runner loads included) [{card}]")
        if len(s_built) != 1 or len(e_built) != 1 or not routed or falls:
            fail("run_diarization did not take the executor route")


class DrillProcess:
    """[13c]'s process: tests/test_torch_hour_scale.hour_drill on the card in
    a process of its own, started at the smoke's start and told to run at
    phase 13. A process started by vfork and exec reports its parent's peak
    RSS as its own on the card's machine (ru_maxrss and VmHWM alike), and by
    phase 13 the smoke holds far more than the drill's bound; started while
    the smoke is still small, the process reads the drill's own peak. It
    exits without running if the smoke ends first (its stdin closes)."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp()
        env = dict(os.environ, CRISPY_DATA_DIR=str(Path(self.tmp) / "Crispy"))
        code = ("import json, sys\n"
                "from pathlib import Path\n"
                "if sys.stdin.readline().strip() != 'go':\n"
                "    sys.exit(0)\n"
                f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
                "import test_torch_hour_scale as h\n"
                "at_go = h.peak_rss_gb()\n"
                f"res = h.hour_drill(Path({self.tmp!r}), 'cuda')\n"
                "print(json.dumps(dict(res, peak_rss_at_start_gb=at_go)))\n")
        self.proc = subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        atexit.register(self.close)

    def run(self, card: str) -> None:
        t0 = time.perf_counter()
        out, err = self.proc.communicate("go\n", timeout=DRILL_TIMEOUT)
        wall = time.perf_counter() - t0
        self.close()
        if self.proc.returncode != 0:
            print(out[-4000:], err[-4000:], sep="\n")
            fail(f"the hour drill failed on the card (exit {self.proc.returncode})")
        res = json.loads(out.strip().splitlines()[-1])
        print(f"[13c] hour drill (tests/test_torch_hour_scale.py: 60 min two-speaker WAV, "
              f"OnnxEncDecEngine over make_canary_bundle, max_new=8, diarization on, cancel "
              f"past 10%, resume, sidecar) on the card: {res}; process wall {wall:.1f} s "
              f"[{card}]")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def encdec_layouts(torch, rng) -> None:
    """[13d] the enc-dec layouts of the JAX package's engine tests through
    load_engine, card against CPU: equal texts and word segments."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_onnx_engines as layouts

    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models.registry import ModelManager

    x = np.stack([speechlike(3 * 16000, rng, 100.0 + 50.0 * b, sr=16000) for b in range(4)])
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        mm = ModelManager(models_dir=Path(tmp) / "Models")
        for mid, make in (("canary-180m-flash", layouts.make_canary_bundle),
                          ("moonshine-base", layouts.make_moonshine_bundle),
                          ("canary-1b-v2", layouts.make_merged_decoder_bundle),
                          ("cohere-int8", layouts.make_canary_bundle)):
            mm.model_path(mid).mkdir(parents=True)
            make(mm.model_path(mid))
            card_eng = tr.load_engine(mid, mm)  # default device: the card
            cpu_eng = tr.load_engine(mid, mm, device="cpu")
            got, want = card_eng.transcribe_batch(x), cpu_eng.transcribe_batch(x)
            segs = (card_eng.transcribe_batch_with_timestamps(x, [0.0] * 4),
                    cpu_eng.transcribe_batch_with_timestamps(x, [0.0] * 4))
            results[mid] = (type(card_eng).__name__, card_eng.kind, got == want,
                            segs[0] == segs[1])
            if got != want or segs[0] != segs[1] or card_eng.device.type != "cuda":
                fail(f"{mid} enc-dec layout on {card_eng.device}: texts equal {got == want}, "
                     f"word segments equal {segs[0] == segs[1]}")
    print(f"[13d] enc-dec layouts through load_engine, card vs CPU (engine, frontend, texts "
          f"equal, word segments equal): {results}")


def encdec_phase(torch, dev, card: str, drill: DrillProcess) -> None:
    from crispy_tpu_torch.models.registry import ModelManager

    t0 = time.perf_counter()
    ties: list = []
    erng = np.random.default_rng(SEED + 9)
    mid = "canary-180m-flash"
    with tempfile.TemporaryDirectory() as tmp:
        with tempfile.TemporaryDirectory() as data:
            os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
            mm = ModelManager(models_dir=Path(tmp) / "Models")
            with torch.no_grad():
                eng = encdec_fullwidth(torch, mm, erng, card, mid)
                t1 = time.perf_counter()
                encdec_card_vs_cpu(torch, mm, erng, mid, eng, ties)
                del eng
                t2 = time.perf_counter()
                executor_hour(torch, dev, card)
            t3 = time.perf_counter()
            drill.run(card)
            t4 = time.perf_counter()
            encdec_layouts(torch, erng)
    print(f"[13] decisions that differ card vs CPU at a near-tie: {len(ties)} {ties}; 13a "
          f"(RTF), 13a (card vs CPU), 13b, 13c, 13d took {t1 - t0:.1f}, {t2 - t1:.1f}, "
          f"{t3 - t2:.1f}, {t4 - t3:.1f}, {time.perf_counter() - t4:.1f} s")


def train_batch_check(torch, training, pipeline, rk, ok, dev) -> dict:
    """[14a]: make_batch at B x F from seed 0 on the card against the port's
    CPU path on the same draws, and K2 and K3 on the inputs the card's own
    frontend gave them; returns the CPU batch."""
    t0 = time.perf_counter()
    with path_k23_inputs(pipeline) as (rd, pg):
        gpu = training.make_batch(pipeline.make_params(None, dev), np.random.default_rng(0),
                                  TRAIN_B, TRAIN_F)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    print(f"[14a] {check_k23(torch, rk, ok, rd, pg, '[14a]')}")
    cpu_params = pipeline.make_params(None, "cpu")
    cpu = training.make_batch(cpu_params, np.random.default_rng(0), TRAIN_B, TRAIN_F)
    _, noisy, _ = training.synth_batch(np.random.default_rng(0), TRAIN_B, TRAIN_F)
    with torch.no_grad():
        _, fr = pipeline.frontend_block(cpu_params, pipeline.init_state(TRAIN_B, "cpu"),
                                        torch.from_numpy(noisy))
    gf, cf = gpu["features"].cpu().numpy(), cpu["features"].numpy()
    same = gf[..., 40] == cf[..., 40]  # the pitch feature: 0.01 (index - 300)
    fd = np.abs(gf - cf).max(-1)[same]
    live = fr["Ex"].numpy() >= 1.0
    gd = np.abs(gpu["gains"].cpu().numpy() - cpu["gains"].numpy())[live]
    mask_diff = gpu["mask"].cpu().numpy() != cpu["mask"].numpy()
    E = fr["Ex"].numpy().sum(-1)[mask_diff]
    print(f"[14a] make_batch B={TRAIN_B} F={TRAIN_F} from seed 0 on the card "
          f"({t_gpu:.2f} s with synth_batch) vs the CPU path: {int((~same).sum())} frames with "
          f"another pitch index; on the rest features max|diff| {fd.max():.3e} (tol "
          f"{BATCH_FEAT_MAX_TOL}), median frame {np.median(fd):.3e} (tol {BATCH_FEAT_MEDIAN_TOL}), "
          f"99th pct {np.quantile(fd, 0.99):.3e}; gains on {int(live.sum())} live bands max "
          f"{gd.max():.3e} (tol {BATCH_GAIN_MAX_TOL}), 99.9th pct {np.quantile(gd, 0.999):.3e} "
          f"(tol {BATCH_GAIN_Q_TOL}); mask differs on {int(mask_diff.sum())} frames (energies "
          f"{np.round(E, 4).tolist()}); vad equal {bool(torch.equal(gpu['vad'].cpu(), cpu['vad']))}")
    if not (fd.max() <= BATCH_FEAT_MAX_TOL and np.median(fd) <= BATCH_FEAT_MEDIAN_TOL):
        fail("[14a] features differ card vs CPU")
    if not (gd.max() <= BATCH_GAIN_MAX_TOL and np.quantile(gd, 0.999) <= BATCH_GAIN_Q_TOL):
        fail("[14a] gains differ card vs CPU")
    if not torch.equal(gpu["vad"].cpu(), cpu["vad"]):
        fail("[14a] vad targets differ")
    # a mask bit may flip only at the silence threshold (E < 0.1 at the x32768 scale)
    if mask_diff.sum() > 0 and not np.all(np.abs(E - 0.1) <= 1e-3):
        fail(f"[14a] masks differ away from the silence threshold: {E}")
    if not all(np.isfinite(v.numpy()).all() for v in cpu.values()):
        fail("[14a] non-finite batch")
    return cpu


def train_step_check(torch, ptrain, dev, batch: dict) -> None:
    """[14b]: the masked loss and its gradients at train_model's init on the
    [14a] CPU batch, on the card against the CPU."""
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal(v.shape) * 0.08).astype(np.float32) if k[-1] in "wu"
         else np.zeros_like(v) for k, v in ptrain.init_train_params().items()}
    out = []
    for d in (dev, torch.device("cpu")):
        net = ptrain.RNNoiseTrainNet(p, d)
        loss = ptrain.loss_fn(net, {k: v.to(d) for k, v in batch.items()})
        loss.backward()
        out.append((float(loss.detach()), {n: q.grad.cpu().numpy() for n, q in net.named_parameters()}))
    (lg, gg), (lc, gc) = out
    rel = {k: float(np.abs(gg[k] - gc[k]).max() / np.abs(gc[k]).max()) for k in gc}
    worst = max(rel, key=rel.get)
    print(f"[14b] one training step's loss on the card {lg:.7f}, CPU {lc:.7f} (rel "
          f"{abs(lg - lc) / abs(lc):.3e}, tol {TRAIN_LOSS_RTOL}); gradients, x each tensor's "
          f"largest |g|: worst {worst} {rel[worst]:.3e} (tol {TRAIN_GRAD_RTOL})")
    if not abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc):
        fail("[14b] the loss differs card vs CPU")
    if not rel[worst] <= TRAIN_GRAD_RTOL:
        fail(f"[14b] the gradient of {worst} differs card vs CPU")


def train_corpus_run(torch, training, dev, card: str, kernels: dict, probe0: tuple):
    """[14c]: train_model in corpus mode on the card, every call timed (host
    clock, synchronised: the losses are read once a call anyway), then
    TRAIN_PROFILE_STEPS more from the last call's state under torch.profiler.
    Beside the times, what the process's state costs them: the launch and
    step probes here against phase 1's (``probe0``) and a new process's at
    this moment, the garbage collector's time and the other threads' CPU
    during train_model. Returns the model, the kernels' launches in the
    train_model call and its loss curve."""
    import gc
    import threading

    walls, last = [], {}
    real = training._corpus_call

    def timed(*args):
        t = time.perf_counter()
        ls = real(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        last["args"] = args
        return ls

    probe = (launch_us(torch), train_step_ms(torch, dev))
    fresh = fresh_probes()
    n_objects = len(gc.get_objects())
    names = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    main_tid = threading.main_thread().native_id
    for k, attr in kernels.values():
        setattr(k, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    cpu0, host0 = thread_cpu(), process_cpu()
    training._corpus_call = timed
    try:
        with gc_time() as gct:
            t0 = time.perf_counter()
            model, losses = training.train_model(
                steps=TRAIN_STEPS, batch_streams=TRAIN_B, frames=TRAIN_F,
                corpus_streams=TRAIN_CORPUS, steps_per_call=TRAIN_SPC, log_every=TRAIN_SPC,
                device=None)
            wall = time.perf_counter() - t0
    finally:
        training._corpus_call = real
    cpu1, host1 = thread_cpu(), process_cpu()
    others = sorted(((cpu1[t][1] - cpu0.get(t, ("", 0.0))[1], cpu1[t][0]) for t in cpu1
                     if t != main_tid), reverse=True)
    procs = sorted(((host1[p][1] - host0.get(p, ("", 0.0))[1], host1[p][0]) for p in host1),
                   reverse=True)
    modes = (torch.autograd.profiler._is_profiler_enabled,
             torch._C._len_torch_function_stack(), torch._C._len_torch_dispatch_stack())
    print(f"[14c] the process's state: launch probe {probe[0]:.2f} us a launch (phase 1: "
          f"{probe0[0]:.2f}; a new process now: {fresh[0]:.2f}), training-step probe "
          f"{probe[1]:.2f} ms (phase 1: {probe0[1]:.2f}; a new process now: {fresh[1]:.2f}); "
          f"{n_objects} objects tracked by the garbage collector, which took "
          f"{', '.join(f'gen {g} {v[0]:.3f} s in {v[1]}' for g, v in gct.items())} during "
          f"train_model; main thread {cpu1[main_tid][1] - cpu0[main_tid][1]:.2f} s CPU, "
          f"{len(cpu1) - 1} other threads {sum(c for c, _ in others):.2f} s (top "
          f"{[(nm, round(c, 2)) for c, nm in others[:4]]}); Python threads {names}; "
          f"{len(host1)} other processes {sum(c for c, _ in procs):.2f} s CPU (top "
          f"{[(nm, round(c, 2)) for c, nm in procs[:4]]}); profiler on, torch function and "
          f"dispatch modes: {modes}")
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
    steady = walls[1:]
    med = float(np.median(steady))
    print(f"[14c] train_model corpus mode B={TRAIN_B} F={TRAIN_F}, {TRAIN_CORPUS} corpus streams, "
          f"{TRAIN_STEPS} steps, {TRAIN_SPC} a call, on the card: wall {wall:.2f} s (corpus build "
          f"and quantization included); calls {', '.join(f'{w:.3f}' for w in walls)} s; "
          f"{1e3 * med / TRAIN_SPC:.2f} ms a step (median of calls 2-{len(walls)}, spread "
          f"{100 * (max(steady) - min(steady)) / med:.1f}%; the first call "
          f"{1e3 * walls[0] / TRAIN_SPC:.2f} ms a step); peak memory {peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held before it; losses "
          f"{[round(v, 4) for v in losses]}; launches {launches} [{card}]")
    if not (len(losses) == TRAIN_STEPS // TRAIN_SPC and np.all(np.isfinite(losses))):
        fail(f"[14c] bad loss curve {losses}")
    if not losses[-1] < losses[0]:
        fail("[14c] the loss did not fall")
    for name in ("rd_scan", "pitch_window_gather"):
        if launches[name] != TRAIN_STEPS:
            fail(f"[14c] {name}: {launches[name]} launches for {TRAIN_STEPS} steps")
    if any(launches[n] for n in kernels if n not in ("rd_scan", "pitch_window_gather")):
        fail(f"[14c] a kernel off the training path launched: {launches}")

    step, net, opt, sched, shards, join = last["args"]
    n = TRAIN_PROFILE_STEPS
    before = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
    cut = [(pools, pipe_params, idx[:, :n], snr[:n]) for pools, pipe_params, idx, snr in shards]
    prof = profile_call(torch, lambda: real(step, net, opt, sched, cut, join), cpu=False)
    k23 = {name: getattr(k, attr) - before[name] for name, (k, attr) in kernels.items()
           if name in ("rd_scan", "pitch_window_gather")}
    print(f"[14c] {n} more step(s) under torch.profiler: {prof['launches'] / n:.0f} launches a step, "
          f"device {prof['device_ms'] / n:.3f} ms of {prof['wall_ms'] / n:.3f} ms a step (busy "
          f"{100 * prof['busy_share']:.1f}%); K2, K3 launches {k23}; top {prof['top']} [{card}]")
    return model, launches, losses


def train_host_run(torch, training, card: str) -> None:
    """[14d]: host mode (one synth_batch a step), with synth_batch's share."""
    spent = []
    real = training.synth_batch

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        spent.append(time.perf_counter() - t)
        return out

    training.synth_batch = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = training.train_model(steps=TRAIN_HOST_STEPS, batch_streams=TRAIN_B,
                                         frames=TRAIN_F, log_every=1)
        wall = time.perf_counter() - t0
    finally:
        training.synth_batch = real
    print(f"[14d] train_model host mode, {TRAIN_HOST_STEPS} steps B={TRAIN_B} F={TRAIN_F}: "
          f"{1e3 * wall / TRAIN_HOST_STEPS:.1f} ms a step, synth_batch "
          f"{1e3 * sum(spent) / len(spent):.1f} ms a step ({100 * sum(spent) / wall:.1f}% of the "
          f"wall); losses {[round(v, 4) for v in losses]} [{card}]")
    if not np.all(np.isfinite(losses)):
        fail("[14d] non-finite loss")


def training_phase(torch, dev, card: str, kernels: dict, probe0: tuple) -> dict:
    from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
    from crispy_tpu_torch.dsp.rnnoise import pipeline, training
    from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
    from crispy_tpu_torch.dsp.rnnoise.weights import RNNoiseModel, builtin_model
    from crispy_tpu_torch.parallel import train as ptrain

    t = [time.perf_counter()]
    batch = train_batch_check(torch, training, pipeline, rk, ok, dev)
    train_step_check(torch, ptrain, dev, batch)
    t.append(time.perf_counter())
    model, launches, losses = train_corpus_run(torch, training, dev, card, kernels, probe0)
    t.append(time.perf_counter())
    train_host_run(torch, training, card)
    t.append(time.perf_counter())

    # [14e] held-out SNR gain: the packaged model card vs CPU, the new model
    before = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
    with path_k23_inputs(pipeline) as (rd, pg):
        g_card = training.snr_improvement(builtin_model())
    k_snr = {name: getattr(k, attr) - before[name] for name, (k, attr) in kernels.items()}
    g_cpu = training.snr_improvement(builtin_model(), device="cpu")
    g_new = training.snr_improvement(model)
    print(f"[14e] held-out SNR improvement of the packaged model: card {g_card:+.4f} dB, CPU "
          f"{g_cpu:+.4f} dB (|diff| {abs(g_card - g_cpu):.2e}, tol {SNR_CARD_TOL}); launches "
          f"{k_snr}; the {TRAIN_STEPS}-step model ({model.name}) on the card {g_new:+.4f} dB")
    print(f"[14e] {check_k23(torch, rk, ok, rd, pg, '[14e]')}")
    if not abs(g_card - g_cpu) <= SNR_CARD_TOL:
        fail("[14e] the SNR gain differs card vs CPU")
    if not np.isfinite(g_new):
        fail("[14e] non-finite SNR gain")
    for name in ("nn_scan", "rd_scan", "pitch_window_gather"):
        if k_snr[name] < 1:
            fail(f"[14e] {name} did not launch in snr_improvement")
    t.append(time.perf_counter())

    # [14f] the training tool in a process of its own, then the CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "trained.npz"
        env = dict(os.environ, CRISPY_DATA_DIR=str(Path(tmp) / "Crispy"))
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "crispy_tpu_torch.tools.train_rnnoise", "--steps",
             str(TOOL_STEPS), "--corpus-streams", str(TOOL_CORPUS), "--out", str(out)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        tool_wall = time.perf_counter() - t1
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            fail(f"[14f] the training tool failed (exit {proc.returncode})")
        loaded = RNNoiseModel.load(out)
        print(f"[14f] python -m crispy_tpu_torch.tools.train_rnnoise --steps {TOOL_STEPS} "
              f"--corpus-streams {TOOL_CORPUS}: {tool_wall:.1f} s; "
              f"{' | '.join(proc.stdout.strip().splitlines())}; the saved model loads as "
              f"{loaded.name!r}")
        if loaded.name != f"synthetic-{TOOL_STEPS}steps-corpus":
            fail("[14f] the saved model is not the tool's")
        cli_lines(Path(tmp) / "Crispy")
    t.append(time.perf_counter())
    print(f"[14] 14a-b, 14c, 14d, 14e, 14f took "
          f"{', '.join(f'{b - a:.1f}' for a, b in zip(t, t[1:]))} s")
    return launches, model, losses


def cli_lines(data: Path) -> None:
    """``cli models list`` and ``cli update`` as a user runs them, the index
    a local stand-in (the machine has no network)."""
    import http.server
    import io
    import threading

    from crispy_tpu_torch import cli
    from crispy_tpu_torch.utils import updater

    class Index(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"info": {"version": "0.1.0"}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Index)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    saved = os.environ.get("CRISPY_DATA_DIR"), updater.INDEX_URL
    os.environ["CRISPY_DATA_DIR"] = str(data)
    updater.INDEX_URL = f"http://127.0.0.1:{srv.server_port}/json"
    try:
        outs = []
        for argv in (["models", "list"], ["update"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            outs.append(buf.getvalue())
            if rc != 0:
                fail(f"[14f] cli {' '.join(argv)} exited {rc}")
    finally:
        srv.shutdown()
        updater.INDEX_URL = saved[1]
        if saved[0] is None:
            os.environ.pop("CRISPY_DATA_DIR", None)
        else:
            os.environ["CRISPY_DATA_DIR"] = saved[0]
    lines = outs[0].strip().splitlines()
    upd = json.loads(outs[1])
    print(f"[14f] cli models list: {len(lines)} lines, last {lines[-1]!r}; cli update: {upd}")
    if len(lines) != 16 or upd["status"] != "up-to-date":
        fail("[14f] the CLI's models list or update is wrong")


class SseClient:
    """A page's ``/events`` listener on its own thread, over a raw socket so
    that ``close`` ends it at once: keeps (arrival time, event, payload) and
    hands each event to ``on_event``."""

    def __init__(self, port: int, on_event=None):
        import socket
        import threading

        self.events: list = []
        self.on_event = on_event
        self._sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self._sock.sendall(f"GET /events HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n\r\n".encode())
        self._file = self._sock.makefile("rb")
        status = self._file.readline().decode()
        if " 200 " not in status:
            fail(f"[15c] /events answered {status.strip()!r}")
        while self._file.readline() not in (b"\r\n", b"\n", b""):
            pass  # the headers
        self.thread = threading.Thread(target=self._read, name="sse-client", daemon=True)
        self.thread.start()

    def _read(self) -> None:
        event = None
        try:
            for raw in self._file:
                line = raw.decode().strip()
                if line.startswith("event:"):
                    event = line[6:].strip()
                elif line.startswith("data:") and event:
                    payload = json.loads(line[5:])
                    self.events.append((time.monotonic(), event, payload))
                    if self.on_event is not None:
                        self.on_event(event, payload)
                    event = None
        except (OSError, ValueError):
            pass  # closed

    def of(self, name: str) -> list:
        return [(t, p) for t, e, p in list(self.events) if e == name]

    def close(self) -> None:
        import socket

        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        self._sock.close()
        self.thread.join(timeout=10)


def http(port: int, method: str, path: str, body=None, headers=None, timeout=600):
    """(status, headers, body bytes) of one request to the served app, as the
    page sends it: JSON bodies for /api."""
    import urllib.error
    import urllib.request

    hdrs = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def api(port: int, name: str, **kwargs):
    """POST /api/<name>: the reply, failing on any status but 200."""
    status, _, body = http(port, "POST", f"/api/{name}", kwargs)
    if status != 200:
        fail(f"[15] /api/{name} answered {status}: {body[:300]!r}")
    return json.loads(body)


def phase_seconds(events, path: str) -> dict:
    """Seconds in each transcription phase of ``path`` from a stream of
    (time, event, payload): each phase until the next, the last until the
    final status."""
    marks = [(t, p["phase"]) for t, e, p in events
             if e == "transcription-phase" and p["recording_path"] == path]
    end = max(t for t, e, p in events
              if e == "transcription-status" and p["recording_path"] == path)
    return {ph: round(t1 - t0, 3) for (t0, ph), t1 in zip(marks, [t for t, _ in marks[1:]] + [end])}


def served_session(torch, card: str, kernels: dict, upload_src: Path) -> dict:
    """Phase 15: the app served on loopback by ``WebServer`` in this process
    and driven only over HTTP, as the page drives it; returns the kernels'
    launches of the session."""
    import threading
    import urllib.parse

    from crispy_tpu_torch.api import ui_state
    from crispy_tpu_torch.api.commands import CrispyApp
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.api.web_server import WEBUI_DIR, WebServer
    from crispy_tpu_torch.dsp.rnnoise.graphed import GraphedBlockStep
    from crispy_tpu_torch.engine import monitoring, recording
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.engine.denoiser import RnnNoiseProcessor
    from crispy_tpu_torch.io import wav as wavio
    from crispy_tpu_torch.models.registry import ModelManager
    from crispy_tpu_torch.models.whisper import CONFIGS
    from crispy_tpu_torch.models.whisper.ggml_io import write_ggml
    from crispy_tpu_torch.models.whisper.weights import init_random

    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    data = Path(tempfile.mkdtemp(prefix="crispy-served-"))
    os.environ["CRISPY_DATA_DIR"] = str(data)  # paths read it; set before the app and server
    app = CrispyApp(bus=EventBus(), data_root=data)  # default device: the card
    # the recording rings, logged for the host replay; the monitor's tap binds
    # the mic ring's push when the engine is built, at the first start_monitoring
    log: list = []
    mic_pushed: list = []
    st = app.recording_state

    st.mic_ring = LoggedRing(st.mic_ring, log, "mic", pushed=mic_pushed)
    st.app_ring = LoggedRing(st.app_ring, log, "app")
    # the monitored device: speech-like audio at 48 kHz, looped
    loop = speechlike(SERVE_LOOP_SECONDS * 48000, np.random.default_rng(SEED + 15), 125.0)
    feed = {"i": 0}

    def device_fn(k):
        i = feed["i"] % loop.size
        feed["i"] += k
        out = loop[i: i + k]
        return out if out.size == k else np.concatenate([out, loop[: k - out.size]])

    app.device_registry.register(monitoring.InputDevice("speech", device_fn, 48000.0))
    # per-frame latency read from the monitoring loop, as [9c] reads push_block,
    # and each graph capture with its thread
    frames: list = []
    captures: list = []
    push0, capture0 = RnnNoiseProcessor.push_block, GraphedBlockStep._capture

    def timed_push(self, block):
        t0 = time.perf_counter()
        out = push0(self, block)
        frames.append((time.monotonic(), (time.perf_counter() - t0) * 1e3))
        return out

    def logged_capture(self, fused):
        t0 = time.monotonic()
        capture0(self, fused)
        captures.append((t0, time.monotonic(), threading.current_thread().name))

    RnnNoiseProcessor.push_block, GraphedBlockStep._capture = timed_push, logged_capture
    srv = WebServer(app, port=0).start()
    port = srv.port
    sse = None
    try:
        # --- 15a: pages and the boundary -----------------------------------------
        t0 = time.perf_counter()
        pages = {}
        for route, name in (("/", "index.html"), ("/tray", "tray.html"),
                            ("/result?path=" + urllib.parse.quote(str(upload_src)), "result.html"),
                            ("/shared.js", "shared.js")):
            status, _, body = http(port, "GET", route)
            pages[route.split("?")[0]] = (status, body == (WEBUI_DIR / name).read_bytes(),
                                          len(body))
        refusals = {
            "foreign Host": http(port, "POST", "/api/get_platform", {},
                                 {"Host": "evil.example:80"})[0],
            "foreign Origin": http(port, "POST", "/api/get_platform", {},
                                   {"Origin": "http://evil.example"})[0],
            "no JSON": http(port, "POST", "/api/get_platform", b"{}",
                            {"Content-Type": "text/plain"})[0],
            "unknown command": http(port, "POST", "/api/quit_app", {})[0],
            "bad kwargs": http(port, "POST", "/api/set_active_model", {"bogus_kw": 1})[0]}
        want = {"foreign Host": 403, "foreign Origin": 403, "no JSON": 415,
                "unknown command": 404, "bad kwargs": 400}
        print(f"[15a] WebServer on 127.0.0.1:{port}: pages (status, bytes equal to the webui "
              f"file, size) {pages}; refusals {refusals} ({time.perf_counter() - t0:.2f} s)")
        if any(s != 200 or not eq for s, eq, _ in pages.values()) or refusals != want:
            fail("[15a] a page or a refusal is wrong")

        # --- 15b: the model in place, selected over /api ---------------------------
        t0 = time.perf_counter()
        cfg = CONFIGS[SERVE_WHISPER]
        models = data / "Models"
        models.mkdir(parents=True, exist_ok=True)
        ggml = write_ggml(models / f"ggml-{SERVE_WHISPER}.bin", init_random(cfg, seed=0),
                          cfg, ttype=1)
        t_write = time.perf_counter() - t0
        api(port, "set_active_model", model_id=SERVE_WHISPER)
        api(port, "set_app_setting", key="diarization_enabled", value="true")
        info = api(port, "get_model_info", model_id=SERVE_WHISPER)
        settings = api(port, "get_app_settings")
        current = api(port, "get_current_model")
        print(f"[15b] whisper-{SERVE_WHISPER} at its published widths (d={cfg.n_audio_state}, "
              f"{cfg.n_audio_layer}+{cfg.n_text_layer} layers), random weights from seed 0, "
              f"written as {ggml.name} ({ggml.stat().st_size / 1e6:.1f} MB) in {t_write:.1f} s; "
              f"/api: current model {current!r}, downloaded {info.get('is_downloaded')}, "
              f"diarization_enabled {settings['diarization_enabled']!r}")
        if current != SERVE_WHISPER or not info.get("is_downloaded") or \
                settings["diarization_enabled"] != "true":
            fail("[15b] the model or the setting did not take")

        # --- 15c: monitoring and recording -----------------------------------------
        ui_bus = EventBus()  # the page's side: SSE events into the UI's tracker
        tracker = ui_state.TranscriptionProgressTracker(bus=ui_bus)
        seen: dict = {}
        transcribing = threading.Event()

        def on_event(name, payload):
            if name.startswith("transcription-"):
                ui_bus.emit(name, payload)
                path = payload.get("recording_path")
                if name == "transcription-progress":
                    seen.setdefault(path, []).append(tracker.get(path)["progress"])
                if name == "transcription-phase" and payload.get("phase") == "transcribing":
                    transcribing.set()

        sse = SseClient(port, on_event)
        for k, attr in kernels.values():
            setattr(k, attr, 0)
        t0 = time.perf_counter()
        api(port, "start_monitoring", device_name="speech", model_name="rnnoise")
        t_first = time.perf_counter() - t0
        time.sleep(1.0)
        rec_path = api(port, "start_recording")
        t_rec, fed0 = time.monotonic(), feed["i"]
        while feed["i"] - fed0 < SERVE_RECORD_SECONDS * 48000:  # the device's audio, not wall
            time.sleep(0.01)
        pace = (feed["i"] - fed0) / 48000 / (time.monotonic() - t_rec)
        out_path = api(port, "stop_recording")
        rec_wall = time.monotonic() - t_rec
        fed = (feed["i"] - fed0) / 48000
        n_log = len(log)
        listed = api(port, "get_recordings")
        if out_path != rec_path or [r["path"] for r in listed] != [out_path]:
            fail(f"[15c] get_recordings lists {listed} for {out_path}")
        disk = Path(out_path).read_bytes()
        q = urllib.parse.quote(out_path)
        size = len(disk)
        reads = {}
        for label, rng, want in (("whole", None, disk), ("standard", "bytes=0-4095", disk[:4096]),
                                 ("open-ended", f"bytes={size // 2}-", disk[size // 2:]),
                                 ("suffix", "bytes=-48000", disk[-48000:])):
            status, h, body = http(port, "GET", f"/stream?path={q}",
                                   headers={"Range": rng} if rng else None)
            reads[label] = (status, h.get("Content-Range"), body == want)
        # the host replay of the mix, from the mic ring's clear at the start
        clear = next(i for i, (nm, op, _) in enumerate(log) if nm == "mic" and op == "clear")
        ops = log[clear:n_log]
        first_push = sum(1 for nm, op, _ in log[:clear] if nm == "mic" and op == "push")
        n_push = sum(1 for nm, op, _ in ops if nm == "mic" and op == "push")
        mic = np.concatenate(mic_pushed[first_push: first_push + n_push])
        expect = replay_mix(ops, mic, np.zeros(mic.size + 1, np.float32), recording.MIX_FRAME,
                            recording.RING_CAPACITY)
        rec_audio, rec_sr = wavio.read_wav(Path(out_path))
        exp16 = np.trunc(np.clip(expect, -1.0, 1.0) * 32767.0)
        got16 = np.round(rec_audio * 32768.0)
        lsb = int(np.abs(got16[:, 0] - exp16).max()) if got16.shape[0] == exp16.size else None
        levels = sse.of("microphone-level")
        timing = [(t, p) for t, p in sse.of("stage-timing") if p.get("stage") == "ns-block"]
        meters = [ui_state.level_meter(p) for _, p in levels]
        print(f"[15c] /api start_monitoring (the card's first use in a request thread: engine, "
              f"graph capture) {t_first:.2f} s; recording {Path(out_path).name} over "
              f"{rec_wall:.2f} s of wall ({fed:.2f} s of the device's audio; the loop's pacing "
              f"{pace:.4f}x realtime until the 30 s were read, min {MON_PACE_MIN}): "
              f"{rec_audio.shape[0]} frames at {rec_sr} Hz, "
              f"host replay of the mix from {len(ops)} logged ring operations: max {lsb} LSB "
              f"(tol 0); L == R: "
              f"{bool(np.array_equal(rec_audio[:, 0], rec_audio[:, 1]))}; /stream reads "
              f"(status, Content-Range, bytes equal) {reads}; SSE so far: {len(levels)} "
              f"microphone-level (level_meter in [{min(meters, default=0):.3f}, "
              f"{max(meters, default=0):.3f}]), {len(timing)} stage-timing")
        if lsb != 0 or not np.array_equal(rec_audio[:, 0], rec_audio[:, 1]) or \
                rec_audio.shape[0] < (SERVE_RECORD_SECONDS - 0.1) * 48000:
            fail(f"[15c] the recording is not the replay of the mix: {lsb} LSB, "
                 f"{got16.shape[0]} frames for {exp16.size}")
        if any(s != (200 if lbl == "whole" else 206) or not eq
               for lbl, (s, _, eq) in reads.items()):
            fail(f"[15c] a /stream read is wrong: {reads}")
        if not pace >= MON_PACE_MIN:
            fail(f"[15c] the monitoring loop paced the device at {pace:.4f}x realtime")
        if not levels or not timing or not all(0.0 <= m <= 1.0 for m in meters):
            fail("[15c] the SSE client missed microphone-level or stage-timing events")

        # --- 15d: upload and transcription under monitoring ------------------------
        t0 = time.perf_counter()
        status, _, body = http(port, "POST", "/upload?name=" + urllib.parse.quote(
            upload_src.name), upload_src.read_bytes(), {"Content-Type": "application/octet-stream"})
        t_upload = time.perf_counter() - t0
        if status != 200:
            fail(f"[15d] /upload answered {status}: {body[:200]!r}")
        uploaded = json.loads(body)["path"]
        if Path(uploaded).read_bytes() != upload_src.read_bytes():
            fail("[15d] the uploaded file differs from the source")
        walls = {}
        t_win0 = time.monotonic()
        for path in (uploaded, out_path):
            transcribing.clear()
            t0 = time.perf_counter()
            if api(port, "start_transcription", recording_path=path) != {"started": True}:
                fail("[15d] start_transcription did not start a thread")
            if path == uploaded:  # restart monitoring while the decode runs
                if not transcribing.wait(timeout=300):
                    fail("[15d] the upload's transcription never reached its decode")
                api(port, "stop_monitoring")
                api(port, "start_monitoring", device_name="speech", model_name="rnnoise")
            deadline = time.time() + 600
            while True:
                state = api(port, "get_transcription_state", recording_path=path)
                if state and state["status"] in ("completed", "error", "cancelled"):
                    break
                if time.time() > deadline:
                    fail(f"[15d] the transcription of {path} did not end: {state}")
                time.sleep(0.05)
            walls[path] = time.perf_counter() - t0
            if state["status"] != "completed":
                fail(f"[15d] the transcription of {path} ended {state}")
        t_win1 = time.monotonic()
        time.sleep(0.5)  # the last SSE events
        served = {p: api(port, "get_transcription_result", recording_path=p)
                  for p in (uploaded, out_path)}
        statuses = {p: [x["status"] for _, x in sse.of("transcription-status")
                        if x["recording_path"] == p] for p in served}
        tracked = {p: tracker.get(p) for p in served}

        # --- 15e: frame latency over the transcription window ----------------------
        win = [ms for t, ms in frames if t_win0 <= t <= t_win1]
        win_max = [p["max_ms"] for t, p in sse.of("stage-timing")
                   if p.get("stage") == "ns-block" and t_win0 <= t <= t_win1 + 1.0]
        late = sum(1 for ms in win if ms > 10.0)
        recap = [c for c in captures if c[0] > captures[0][0]]

        # --- 15f: kernels and teardown ---------------------------------------------
        api(port, "stop_monitoring")
        launches = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
    finally:
        RnnNoiseProcessor.push_block, GraphedBlockStep._capture = push0, capture0
        if sse is not None:
            sse.close()
        srv.stop()
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30

    # the direct path: run_transcription on the card with the same model and
    # diarization setting the app passed
    diar = {"enabled": True, "max_speakers": int(settings["diarization_max_speakers"] or 6),
            "merge_gap": float(settings["diarization_merge_gap"] or 2.5)}
    tm = tr.TranscriptionManager(ModelManager(models_dir=models), bus=EventBus())
    direct_events: list = []
    for name in ("transcription-phase", "transcription-status"):
        tm.bus.listen(name, lambda x, n=name: direct_events.append((time.monotonic(), n, x)))
    direct, direct_wall = {}, {}
    for p in served:
        t0 = time.perf_counter()
        direct[p] = tr.run_transcription(p, tm, SERVE_WHISPER, diarization=diar)
        torch.cuda.synchronize()
        direct_wall[p] = time.perf_counter() - t0
    for p in served:
        tags = [(s["speaker"], s["timestamp"]) for s in ui_state.parse_transcript_segments(
            served[p] or "")]
        dtags = [(s["speaker"], s["timestamp"]) for s in ui_state.parse_transcript_segments(
            direct[p] or "")]
        print(f"[15d] {Path(p).parent.name}/{Path(p).name}: served wall {walls[p]:.2f} s "
              f"(request to completed), {len(served[p] or '')} characters, speaker tags "
              f"{len(tags)} ({sorted(set(t for t, _ in tags))}); statuses over SSE "
              f"{statuses[p]}, the tracker's progress {seen.get(p)} -> {tracked[p]}; direct "
              f"run_transcription on the card {direct_wall[p]:.2f} s (served/direct "
              f"{walls[p] / direct_wall[p]:.3f}): text equal "
              f"{served[p] == direct[p]}, tags equal {tags == dtags}; seconds a phase, served "
              f"(SSE arrival) {phase_seconds(sse.events, p)}, direct "
              f"{phase_seconds(direct_events, p)}")
        prog = seen.get(p) or []
        if served[p] != direct[p] or tags != dtags or not served[p] or \
                (p == uploaded and not tags):
            fail(f"[15d] the served transcript of {p} differs from the direct run")
        if not prog or prog != sorted(prog) or prog[-1] != 1.0 or \
                tracked[p]["status"] != "completed" or tracked[p]["progress"] != 1.0:
            fail(f"[15d] the tracker's progress of {p} did not reach 100%: {prog}, {tracked[p]}")
    t_dec = min(t for t, x in sse.of("transcription-phase")
                if x["recording_path"] == uploaded and x["phase"] == "transcribing")
    t_done = min(t for t, x in sse.of("transcription-status")
                 if x["recording_path"] == uploaded and x["status"] == "completed")
    print(f"[15d] upload of {upload_src.stat().st_size / 1e6:.1f} MB in {t_upload:.2f} s; graph "
          f"captures (start, end, thread; s from the first start_transcription) "
          f"{[(round(a - t_win0, 3), round(b - t_win0, 3), n) for a, b, n in captures]}; the "
          f"upload's decode from {t_dec - t_win0:.3f} to {t_done - t_win0:.3f} s")
    if not recap or not any(t_dec <= a and b <= t_done and "process_request_thread" in n
                            for a, b, n in recap):
        fail("[15d] no graph was captured in a request thread during the upload's decode")
    med = float(np.median(win)) if win else float("inf")
    print(f"[15e] push_block in the monitoring loop over the transcription window "
          f"({t_win1 - t_win0:.2f} s): {percentiles(win)}, {late} frames over the 10 ms budget; "
          f"stage-timing max_ms a second as the UI sees it: {win_max} [{card}]")
    if not med <= 10.0:
        fail(f"[15e] the per-frame median {med:.3f} ms under transcription exceeds 10 ms")

    print(f"[15f] launches in [15]: {launches}; peak device memory {peak:.3f} GiB above the "
          f"phase's start")
    for name, c in launches.items():
        if (c > 0) != (name in ("nn_scan", "rd_scan", "pitch_window_gather")):
            fail(f"[15f] kernel {name}: {c} launches in the served session")
    deadline = time.time() + 5
    while True:  # the server's own thread ends just after stop() returns
        left = [t for t in set(threading.enumerate()) - threads0
                if not (t.daemon and "process_request_thread" in t.name)]
        if not left or time.time() > deadline:
            break
        time.sleep(0.05)
    print(f"[15f] threads of the session left: {sorted(t.name for t in left)} (SSE handlers "
          f"excepted)")
    if left:
        fail(f"[15f] threads left after teardown: {left}")
    shutil.rmtree(data, ignore_errors=True)
    print(f"[15] 15a-f took {time.perf_counter() - t_phase:.1f} s")
    return launches


def serve_cli_line() -> None:
    """Phase 15g: ``cli serve`` in a process of its own, stopped by Ctrl-C."""
    import signal
    import threading

    with tempfile.TemporaryDirectory() as data:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "crispy_tpu_torch.cli", "serve",
                                 "--port", "0"], cwd=ROOT,
                                env={**os.environ, "CRISPY_DATA_DIR": data},
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line: list = []
            reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                                      daemon=True)
            reader.start()
            reader.join(timeout=120)
            if not line or not line[0]:
                fail(f"[15g] cli serve printed nothing (exit {proc.poll()})")
            info = json.loads(line[0])
            port = int(info["url"].rsplit(":", 1)[1].strip("/"))
            status, _, page = http(port, "GET", "/")
            platform = api(port, "get_platform")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err = proc.stderr.read()
        print(f"[15g] python -m crispy_tpu_torch.cli serve --port 0: {info}; GET / {status} "
              f"({len(page)} bytes), /api/get_platform {platform!r}; exit {rc} after Ctrl-C "
              f"({time.perf_counter() - t0:.1f} s)")
        if status != 200 or rc != 0 or info["recordings"] != str(Path(data) / "Recordings"):
            fail(f"[15g] cli serve failed: {err[-2000:]}")


# ---------------------------------------------------------------------------
# Phase 16: one process over a list of devices (a mesh of the one card)
# ---------------------------------------------------------------------------

MESH_BLOCKS = 4  # phase 16a: blocks a stream through denoise_batch
MESH_DP = (2, 3)  # data rows of the meshes of 16a and 16c (S=128 pads to 129 at 3)
MESH_SCALE_RTOL = 1e-5  # 16c: DynamicQuantizeLinear scales sharded vs unsharded, relative
MESH_NOTE = "repeated entries of one card, not a multi-GPU speed-up"


def card_mesh(n: int, model_parallel=None):
    from crispy_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * n, model_parallel=model_parallel)


def pitch_calls(pipeline):
    """Record every _pitch_index call's indices (a tensor on the card, read
    after the run) while the block runs."""
    calls, real = [], pipeline._pitch_index

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out[0])
        return out

    @contextlib.contextmanager
    def ctx():
        pipeline._pitch_index = spy
        try:
            yield calls
        finally:
            pipeline._pitch_index = real

    return ctx()


def stitch_pitch(calls, dp: int, S: int) -> np.ndarray:
    """[S, frames] from the calls of a run: per block, dp shard calls in row
    order."""
    blocks = [np.concatenate([c.cpu().numpy() for c in calls[i:i + dp]])[:S]
              for i in range(0, len(calls), dp)]
    return np.concatenate(blocks, axis=1)


def mesh_denoise(torch, pipeline, params, card: str, kernels: dict) -> dict:
    """[16a] denoise_batch at S=128 x F=500, MESH_BLOCKS blocks a stream, on
    both spectra paths, unsharded and over meshes of dp entries of the card."""
    rng = np.random.default_rng(SEED + 16)
    base = np.stack([speechlike(2 * F_MAIN * pipeline.FRAME, rng, 85.0 + 1.5 * s)
                     for s in range(S_MAIN)])
    audio = np.tile(base, (1, MESH_BLOCKS // 2))
    total = {name: 0 for name in kernels}
    for path, expect in (("off", ("nn_scan", "rd_scan", "pitch_window_gather")),
                         ("on", ("nn_scan", "rd_scan", "pitch_window_gather",
                                 "fwd_spectrum_bands", "win_spectrum_bands",
                                 "inv_spectrum_ola"))):
        with spectra_path(path):
            pipeline.denoise_batch(audio[:, :F_MAIN * pipeline.FRAME], params=params)  # warm-up
            torch.cuda.synchronize()
            with pitch_calls(pipeline) as calls:
                t0 = time.perf_counter()
                want = pipeline.denoise_batch(audio, params=params)
                wall0 = time.perf_counter() - t0
                p_want = stitch_pitch(calls, 1, S_MAIN)
            for dp in MESH_DP:
                mesh = card_mesh(dp, model_parallel=1)
                for k, attr in kernels.values():
                    setattr(k, attr, 0)
                with pitch_calls(pipeline) as calls:
                    t0 = time.perf_counter()
                    got = pipeline.denoise_batch(audio, params=params, mesh=mesh)
                    wall = time.perf_counter() - t0
                    counts = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
                    p_got = stitch_pitch(calls, dp, S_MAIN)
                err = float(np.abs(got - want).max())
                n_diff = int(np.sum(p_got != p_want))
                print(f"[16a] {'fused-spectra' if path == 'on' else 'FFT'} path, "
                      f"S={S_MAIN} F={F_MAIN} x {MESH_BLOCKS} blocks over dp={dp} "
                      f"(S pads to {-(-S_MAIN // dp) * dp}): max|diff| vs unsharded {err:.3e} "
                      f"(tol {F32_TOL}), pitch indices differing {n_diff} of {p_want.size}; "
                      f"launches {counts}; wall {wall:.3f} s, unsharded {wall0:.3f} s "
                      f"({MESH_NOTE}) [{card}]")
                if got.shape != audio.shape or not np.isfinite(got).all() or not err <= F32_TOL:
                    fail(f"[16a] dp={dp} differs from the unsharded run by {err}")
                for name, c in counts.items():
                    want_c = dp * MESH_BLOCKS if name in expect else 0
                    if c != want_c:
                        fail(f"[16a] {name}: {c} launches, want {want_c}")
                    total[name] += c
    if torch.cuda.current_device() != 0:
        fail("[16a] a launch moved the calling thread's current device")
    print("[16a] the launchers restore the caller's current device (csrc/device_guard.cuh): "
          "unverified here, one card cannot show a move")
    return total


def mesh_whisper(torch, card: str, ggml: Path, wav: Path, manager, want_text: str,
                 wall0: float) -> None:
    """[16b] whisper-base at its published widths over a (2, 2) mesh of the
    card: run_transcription of the phase-8 WAV, and teacher-forced logits
    on one B=8 batch."""
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models.whisper import WhisperModel

    mesh = card_mesh(4)
    tm = tr.TranscriptionManager(manager, bus=EventBus(), mesh=mesh)
    tr.clear_transcription_progress(str(wav))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = tr.run_transcription(str(wav), tm, manager.info.id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[16b] run_transcription of the {E2E_SECONDS} s phase-8 WAV through "
          f"TranscriptionManager(mesh={mesh.devices.shape}): {len(text or '')} characters, equal "
          f"to the unsharded call's: {text == want_text}; wall {wall:.3f} s (model load "
          f"included), unsharded {wall0:.3f} s ({MESH_NOTE}) [{card}]")
    if not text or text != want_text:
        fail("[16b] the sharded transcript differs from the unsharded one")
    plain = WhisperModel.from_ggml(ggml)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sharded = WhisperModel.from_ggml(ggml)
    torch.cuda.synchronize()
    one = torch.cuda.memory_allocated() - before
    sharded.shard_to(mesh)
    torch.cuda.synchronize()
    extra = torch.cuda.memory_allocated() - before - one
    rng = np.random.default_rng(SEED + 17)
    audio = asr_chunks(rng, 8)[:, : 30 * 16000]
    cfg = plain.cfg
    tok = torch.from_numpy(rng.integers(0, cfg.n_vocab, (8, 24)))
    tok[:, 0] = cfg.sot
    with torch.no_grad():
        lp = plain.decode_logits(audio, tok)
        t0 = time.perf_counter()
        ls = sharded.decode_logits(audio, tok)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
    err = rel_err(ls, lp)
    print(f"[16b] teacher-forced logits of B=8 x 24 tokens over the (2, 2) mesh vs unsharded: "
          f"max|diff| {err:.3e} of their max (tol {LOGIT_RTOL}), {t_s:.3f} s; the model "
          f"{one / 2**20:.1f} MiB on the card, its (2, 2) placement {extra / 2**20:.1f} MiB more "
          f"(four entries of one card share one copy) [{card}]")
    if not err <= LOGIT_RTOL:
        fail(f"[16b] sharded logits differ by {err}")
    if extra > 0.1 * one:
        fail(f"[16b] the placement took {extra} bytes beside a {one}-byte model")


def mesh_onnx(torch, card: str, mm, mid: str, eng) -> None:
    """[16c] the phase-12a full-width int8 parakeet-tdt-0.6b-v3 bundle, B=8 x
    30 s, over dp=2 and dp=3 entries of the card: transcripts and every
    DynamicQuantizeLinear scale of the encoder against the unsharded call."""
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.models import onnx_exec as ox

    rng = np.random.default_rng(SEED + 18)
    x = torch.from_numpy(asr_chunks(rng, 8)).cuda()
    real = ox._dql_codes
    scales: list = []

    def rec(xx, lo, hi):
        out = real(xx, lo, hi)
        scales.append(out[1])
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = eng.transcribe_batch(x)
    wall0 = time.perf_counter() - t0
    ox._dql_codes = rec
    try:
        eng.encoder_output(x)
        s_want = np.array([float(v) for v in scales])
        for dp in MESH_DP:
            t0 = time.perf_counter()
            sh = tr.load_engine(mid, mm, mesh=card_mesh(dp, model_parallel=1))
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ox._dql_codes = real
            got = sh.transcribe_batch(x)
            wall = time.perf_counter() - t0
            ox._dql_codes = rec
            scales.clear()
            sh.encoder_output(x)
            s_got = np.array([float(v) for v in scales]).reshape(len(s_want), dp)
            s_err = float(np.abs(s_got / s_want[:, None] - 1).max())
            print(f"[16c] {mid} B=8 x 30 s over dp={dp} (B pads to {-(-8 // dp) * dp}): "
                  f"transcripts equal to the unsharded call's: {got == want}; "
                  f"{len(s_want)} DynamicQuantizeLinear scales of the encoder, each shard's "
                  f"against the unsharded one: max relative diff {s_err:.3e} (tol "
                  f"{MESH_SCALE_RTOL}); load_engine {load_s:.1f} s; transcribe_batch {wall:.3f} s, "
                  f"unsharded {wall0:.3f} s ({MESH_NOTE}) [{card}]")
            if got != want or not all(got):
                fail(f"[16c] dp={dp} transcripts differ from the unsharded call's")
            if not s_err <= MESH_SCALE_RTOL:
                fail(f"[16c] dp={dp} quantization scales differ by {s_err}")
            del sh
    finally:
        ox._dql_codes = real


def mesh_diarization(torch, card: str, diar: dict) -> None:
    """[16d] the phase-11 hour over dp=2 entries of the card: the built-in
    route (segments, margins bit-equal, NME-SC labels) and the PyanNet +
    CAM++ from_device route at [11b]'s widths (speakers)."""
    from crispy_tpu_torch.engine import diar_device as dd
    from crispy_tpu_torch.engine import diarization as td

    audio, seg, cam = diar["audio"], diar["seg"], diar["cam"]
    mesh = card_mesh(2, model_parallel=1)
    seconds = audio.shape[0] / td.SAMPLE_RATE
    with torch.no_grad():
        walls = {}
        for tag, m in (("unsharded", None), ("dp=2", mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = td.diarize(audio, max_speakers=8, merge_gap=1.0, mesh=m)
            walls[tag] = (time.perf_counter() - t0, out)
        same = speaker_segments(walls["dp=2"][1]) == speaker_segments(walls["unsharded"][1])
        q, pad_to = td._upload_i16(audio, torch.device("cuda:0"))
        m0 = dd.segmentation_margins(q, pad_to)
        mm = dd.segmentation_margins(q, pad_to, mesh)
        logits = np.stack([-m0, m0], axis=-1)
        segments = td._segments_from_runs(td._runs_from_logits(logits, audio.shape[0], 1.0),
                                          audio)
        chunks = td.chunk_segments(segments)
        ranges = [(c.offset, c.offset + len(c.samples)) for c in chunks]
        e0 = dd.chunk_stats(q, pad_to, ranges)
        em = dd.chunk_stats(q, pad_to, ranges, mesh)
        l0, lm = td.nme_sc(e0, 8), td.nme_sc(e0, 8, mesh=mesh)
        print(f"[16d] diarize of {seconds:.0f} s, built-in route, dp=2: "
              f"{len(walls['dp=2'][1])} speaker segments, equal to unsharded: {same}; "
              f"margins {m0.shape} bit-equal: {np.array_equal(m0, mm)}; chunk statistics of "
              f"{len(ranges)} chunks bit-equal: {np.array_equal(e0, em)}; NME-SC labels "
              f"equal: {np.array_equal(l0, lm)}; wall {walls['dp=2'][0]:.3f} s, unsharded "
              f"{walls['unsharded'][0]:.3f} s ({MESH_NOTE}) [{card}]")
        if not (same and np.array_equal(m0, mm) and np.array_equal(e0, em)
                and np.array_equal(l0, lm)):
            fail("[16d] the built-in route differs sharded vs unsharded")
        with CudaStages(torch) as st:
            nets = dict(segmentation_fn=StagedSegmentation(seg, dd, st),
                        embedding_fn=StagedEmbedding(cam, dd, st))
            res = {}
            for tag, m in (("unsharded", None), ("dp=2", mesh)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = td.diarize(audio, max_speakers=8, merge_gap=1.0, mesh=m, **nets)
                res[tag] = (time.perf_counter() - t0, out)
        same = speaker_segments(res["dp=2"][1]) == speaker_segments(res["unsharded"][1])
        print(f"[16d] the same hour through PyanNet + CAM++'s from_device route ([11b]'s "
              f"widths, staged), dp=2: {len(res['dp=2'][1])} speaker segments, equal to "
              f"unsharded: {same}; wall {res['dp=2'][0]:.3f} s, unsharded "
              f"{res['unsharded'][0]:.3f} s ({MESH_NOTE}) [{card}]")
        if not res["dp=2"][1] or not same:
            fail("[16d] the from_device route's speakers differ sharded vs unsharded")


def mesh_app(torch, card: str, ggml: Path, wav: Path) -> None:
    """[16e] CrispyApp: no mesh on one card by default; over
    make_mesh(["cuda:0"] * 2) start_transcription with diarization on
    completes and equals the unsharded app's transcript."""
    from crispy_tpu_torch.api.commands import CrispyApp
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import transcription as tr

    old = os.environ.pop("CRISPY_MESH", None)
    try:
        texts, walls = {}, {}
        with tempfile.TemporaryDirectory() as data:
            os.environ["CRISPY_DATA_DIR"] = data
            models = Path(data) / "Models"
            models.mkdir(parents=True)
            shutil.copyfile(ggml, models / "ggml-small.bin")  # whisper-base under "small"
            rec = Path(data) / "rec.wav"
            shutil.copyfile(wav, rec)
            for tag, mesh in (("unsharded", None), ("mesh", card_mesh(2))):
                app = CrispyApp(bus=EventBus()) if mesh is None else \
                    CrispyApp(bus=EventBus(), mesh=mesh)
                if mesh is None and app.resolved_mesh() is not None:
                    fail(f"[16e] CRISPY_MESH unset on one card resolved to {app.mesh}")
                app.set_active_model("small")
                app.set_app_setting("diarization_enabled", "true")
                tr.clear_transcription_progress(str(rec))
                t0 = time.perf_counter()
                app.start_transcription(str(rec)).join(timeout=600)
                walls[tag] = time.perf_counter() - t0
                st = app.get_transcription_state(str(rec))
                if not st or st["status"] != "completed":
                    fail(f"[16e] the {tag} app's transcription ended in {st}")
                texts[tag] = app.get_transcription_result(str(rec))
        tags = sorted(set(__import__("re").findall(r"\[(Speaker \d+)\|", texts["mesh"] or "")))
        print(f"[16e] CrispyApp: resolved_mesh() None with CRISPY_MESH unset on one card; "
              f"over make_mesh(['cuda:0'] * 2) start_transcription with diarization of the "
              f"phase-8 WAV completed, {len(texts['mesh'] or '')} characters, speakers {tags}, "
              f"equal to the unsharded app's: {texts['mesh'] == texts['unsharded']}; wall "
              f"{walls['mesh']:.3f} s, unsharded {walls['unsharded']:.3f} s ({MESH_NOTE}) "
              f"[{card}]")
        if not texts["mesh"] or texts["mesh"] != texts["unsharded"] or not tags:
            fail("[16e] the app's sharded transcription differs from the unsharded one")
    finally:
        if old is not None:
            os.environ["CRISPY_MESH"] = old



# ---------------------------------------------------------------------------
# Phase 17: training over a mesh, and several processes on the one card
# ---------------------------------------------------------------------------

MP_STEPS = 5  # 17a, 17c: DP training steps at TRAIN_B x TRAIN_F
MP_LOSS_RTOL = 1e-5  # 17a, 17c: losses sharded vs unsharded, relative
MP_PARAM_RTOL = 1e-5  # 17a, 17c: parameters after the steps, x each tensor's largest |value|
MP_MODEL_RTOL = 1e-4  # 17b: loss curves sharded vs unsharded, relative
MP_PROCS = 2  # 17c: processes sharing the card
MP_ASR_B, MP_ASR_NEW = 8, 8  # 17c: whisper-base chunks (30 s mel) and new tokens
MP_TIMEOUT = 300  # 17c: seconds for the ranks (each collective gives up after it too)


def mp_params(ptrain) -> dict:
    """17a, 17c: train_model's init draw (0.08 N(0, 1)), biases included."""
    rng = np.random.default_rng(SEED + 17)
    return {k: (rng.standard_normal(v.shape) * 0.08).astype(np.float32)
            for k, v in ptrain.init_train_params().items()}


def mp_batch(ptrain, step: int) -> dict:
    """17a, 17c: the global batch of a step, silence frames masked."""
    batch = ptrain.synthetic_batch(TRAIN_B, TRAIN_F, seed=SEED + 100 + step)
    rng = np.random.default_rng(SEED + 200 + step)
    batch["mask"] = (rng.uniform(0, 1, (TRAIN_B, TRAIN_F)) > 0.3).astype(np.float32)
    return batch


def mp_audio(rows: range) -> np.ndarray:
    """17c: ``rows`` of the global denoise batch (S_MAIN streams x one
    block): stream s is 1 s of speech-like audio from its own seed, repeated
    over the block, so a rank makes only its own rows."""
    n = F_MAIN * 480
    one = [speechlike(min(n, 48000), np.random.default_rng(SEED + 300 + s), 80.0 + 2.0 * s)
           for s in rows]
    return np.stack([np.resize(x, n) for x in one])


def mp_mel(n_mels: int) -> np.ndarray:
    """17c: the global whisper batch, MP_ASR_B 30 s log-mel chunks."""
    rng = np.random.default_rng(SEED + 400)
    return (rng.standard_normal((MP_ASR_B, n_mels, 3000)) * 0.5).astype(np.float32)


def mp_train(torch, ptrain, dev=None, mesh=None):
    """MP_STEPS steps of make_train_step (on dev, or over mesh) from
    mp_params: (losses, parameters, replicas bit-equal, host wall)."""
    step, to_params, to_batch, optimizer = ptrain.make_train_step(dev, mesh=mesh)
    net = to_params(mp_params(ptrain))
    opt = optimizer(net)
    batches = [mp_batch(ptrain, s) for s in range(MP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        net, opt, loss = step(net, opt, to_batch(b))
        losses.append(loss)
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    params = net.params_to_numpy()
    equal = all(np.array_equal(rep.params_to_numpy()[k], params[k])
                for rep in getattr(net, "replicas", [net]) for k in params)
    return np.array(losses), params, equal, wall


def mp_check(tag: str, want, got) -> str:
    """17a, 17c: losses and parameters against the unsharded run's."""
    wl, wp = want[0], want[1]
    gl, gp = got[0], got[1]
    lrel = float(np.max(np.abs(gl - wl) / np.abs(wl)))
    prel = {k: float(np.abs(gp[k] - wp[k]).max() / np.abs(wp[k]).max()) for k in wp}
    worst = max(prel, key=prel.get)
    if not lrel <= MP_LOSS_RTOL:
        fail(f"{tag} losses {gl} against unsharded {wl}")
    if not prel[worst] <= MP_PARAM_RTOL:
        fail(f"{tag} parameter {worst} {prel[worst]:.3e} of its largest from unsharded")
    return (f"losses {lrel:.3e} relative (tol {MP_LOSS_RTOL}), parameters worst {worst} "
            f"{prel[worst]:.3e} of its largest (tol {MP_PARAM_RTOL})")


def rank_17c(outdir: Path, ggml: Path) -> int:
    """One rank of [17c] (``chip_smoke.py --rank17c OUTDIR GGML``), started
    by ``multihost.launch_local``: its rows of the global denoise and
    whisper batches over ``mesh.local``, MP_STEPS DP training steps over the
    process mesh; writes rank<i>.npz with the launches of K1-K3."""
    import torch

    sys.path.insert(0, str(ROOT))
    from crispy_tpu_torch import _build
    from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
    from crispy_tpu_torch.dsp.rnnoise import pipeline
    from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
    from crispy_tpu_torch.dsp.rnnoise.weights import builtin_model
    from crispy_tpu_torch.models.whisper import WhisperModel
    from crispy_tpu_torch.models.whisper.model import greedy_decode
    from crispy_tpu_torch.parallel import multihost as mh
    from crispy_tpu_torch.parallel import train as ptrain

    t0 = time.perf_counter()
    backend = mh.initialize_from_env(local_device_count=1, timeout=MP_TIMEOUT)
    mesh = mh.global_data_mesh()
    pid, n = mesh.process_index, mesh.process_count
    _build.load()  # built by the parent
    walls = {"start": time.perf_counter() - t0}
    counters = ((rk.nn_scan, "launches"), (rk.rd_scan, "launches"),
                (ok.pitch_window_gather, "launches"))
    for k, attr in counters:
        setattr(k, attr, 0)

    b = S_MAIN // n
    mine = mp_audio(range(pid * b, (pid + 1) * b))
    params = pipeline.make_params(builtin_model(), mesh.local.first)
    t = time.perf_counter()
    rows = pipeline.denoise_batch(mine, params=params, block_frames=F_MAIN, mesh=mesh.local)
    walls["denoise"] = time.perf_counter() - t

    wm = WhisperModel.from_ggml(ggml, device=mesh.local.first).shard_to(mesh.local)
    a = MP_ASR_B // n
    mel = mh.feed_process_local(mesh, mp_mel(wm.cfg.n_mels)[pid * a:(pid + 1) * a])
    prompt = mh.feed_process_local(mesh, np.full((a, 1), wm.cfg.sot, np.int64))
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = mh.gather_local([greedy_decode(rep, m, p, max_new=MP_ASR_NEW, eot=wm.cfg.eot)[0]
                            for rep, m, p in zip(wm.replicas, mel.parts, prompt.parts)])
    walls["whisper"] = time.perf_counter() - t
    launches = [getattr(k, attr) for k, attr in counters]

    losses, got, equal, walls["train"] = mp_train(torch, ptrain, mesh=mesh)
    if not equal:
        raise RuntimeError("the replicas differ")
    np.savez(outdir / f"rank{pid}.npz", rows=rows, tokens=toks, losses=losses,
             launches=np.array(launches), backend=np.array(backend),
             devices=np.array(mesh.devices.size), walls=np.array(json.dumps(walls)),
             **{f"param:{k}": v for k, v in got.items()})
    torch.distributed.destroy_process_group()
    print(f"[rank {pid}] 17c done: backend {backend}", flush=True)
    return 0


def multiprocess_phase(torch, pipeline, params, dev, card: str, kernels: dict, ggml: Path,
                       unsharded: tuple) -> dict:
    """[17a] make_train_step over meshes of the card, [17b] [14c]'s
    train_model call over dp=2 against [14c]'s (``unsharded``: its model and
    loss curve), [17c] two processes sharing the card (their ranks run while
    17a and 17b run here). Returns the launches of the phase's paths."""
    from concurrent.futures import ThreadPoolExecutor

    from crispy_tpu_torch.dsp.rnnoise import training
    from crispy_tpu_torch.models.whisper import WhisperModel
    from crispy_tpu_torch.models.whisper.model import greedy_decode
    from crispy_tpu_torch.parallel import multihost as mh
    from crispy_tpu_torch.parallel import train as ptrain

    tmp = Path(tempfile.mkdtemp())
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--rank17c", str(tmp), str(ggml)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mh.launch_local, argv, MP_PROCS, f"file://{tmp}/rendezvous",
                            MP_TIMEOUT, tmp / "logs")
        # [17a] make_train_step over (2, 1) and (2, 2), against the unsharded step
        want = mp_train(torch, ptrain, dev=dev)
        for shape in ((2, 1), (2, 2)):
            got = mp_train(torch, ptrain, mesh=card_mesh(shape[0] * shape[1], shape[1]))
            if not got[2]:
                fail(f"[17a] {shape}: the replicas differ")
            print(f"[17a] make_train_step over {shape} ({MESH_NOTE}), {MP_STEPS} steps at "
                  f"B={TRAIN_B} F={TRAIN_F} against the unsharded step: "
                  f"{mp_check(f'[17a] {shape}', want, got)}; replicas bit-equal; host wall "
                  f"{got[3]:.3f} s (unsharded {want[3]:.3f} s) [{card}]")
        t1 = time.perf_counter()
        # [17b] [14c]'s train_model call over dp=2, against [14c]'s run of it
        model0, l0 = unsharded
        for k, attr in kernels.values():
            setattr(k, attr, 0)
        t = time.perf_counter()
        model1, l1 = training.train_model(
            steps=TRAIN_STEPS, batch_streams=TRAIN_B, frames=TRAIN_F, corpus_streams=TRAIN_CORPUS,
            steps_per_call=TRAIN_SPC, log_every=TRAIN_SPC, mesh=card_mesh(2, 1))
        w1 = time.perf_counter() - t
        launches = {name: getattr(k, attr) for name, (k, attr) in kernels.items()}
        rel = float(np.max(np.abs(np.array(l1) - np.array(l0)) / np.abs(l0)))
        codes = sum(int(np.sum(getattr(getattr(model0, g), f) != getattr(getattr(model1, g), f)))
                    for g in ("input_dense", "denoise_output", "vad_output", "vad_gru",
                              "noise_gru", "denoise_gru")
                    for f in ("w", "b") + (("u",) if g.endswith("gru") else ()))
        print(f"[17b] [14c]'s train_model call over dp=2 ({MESH_NOTE}), {TRAIN_STEPS} steps of "
              f"{TRAIN_SPC} a call, B={TRAIN_B} F={TRAIN_F}, {TRAIN_CORPUS} corpus streams: "
              f"losses {[round(v, 6) for v in l1]} against [14c]'s {[round(v, 6) for v in l0]} "
              f"({rel:.3e} relative, tol {MP_MODEL_RTOL}); int8 codes differing {codes}; K2, K3 "
              f"launches {launches['rd_scan']}, {launches['pitch_window_gather']} ({TRAIN_STEPS} "
              f"steps x 2 shards); host wall {w1:.2f} s (corpus build included) [{card}]")
        if not (len(l1) == len(l0) and rel <= MP_MODEL_RTOL):
            fail("[17b] the loss curve over the mesh differs from the unsharded one")
        for name in ("rd_scan", "pitch_window_gather"):
            if launches[name] != 2 * TRAIN_STEPS:
                fail(f"[17b] {name}: {launches[name]} launches for {TRAIN_STEPS} steps x 2")
        t2 = time.perf_counter()
        logs = ranks.result()
    t3 = time.perf_counter()
    # [17c] the ranks against this process's runs of the whole batches
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(MP_PROCS)]
    audio = mp_audio(range(S_MAIN))
    t = time.perf_counter()
    whole = pipeline.denoise_batch(audio, params=params, block_frames=F_MAIN, device=dev)
    w_den = time.perf_counter() - t
    wm = WhisperModel.from_ggml(ggml, device=dev)
    mel = torch.from_numpy(mp_mel(wm.cfg.n_mels)).to(dev)
    prompt = torch.full((MP_ASR_B, 1), wm.cfg.sot, dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = greedy_decode(wm.model, mel, prompt, max_new=MP_ASR_NEW, eot=wm.cfg.eot)[0].cpu().numpy()
    w_asr = time.perf_counter() - t
    b, a = S_MAIN // MP_PROCS, MP_ASR_B // MP_PROCS
    names = ("nn_scan", "rd_scan", "pitch_window_gather")
    for r, g in enumerate(got):
        if str(g["backend"]) != "gloo" or int(g["devices"]) != MP_PROCS:
            fail(f"[17c] rank {r}: backend {g['backend']}, {g['devices']} devices in the job")
        err = float(np.abs(g["rows"] - whole[r * b:(r + 1) * b]).max())
        same = bool(np.array_equal(g["tokens"], toks[r * a:(r + 1) * a]))
        check = mp_check(f"[17c] rank {r}", want, (g["losses"], {k[6:]: v for k, v in g.items()
                                                               if k.startswith("param:")}))
        walls = json.loads(str(g["walls"]))
        print(f"[17c] rank {r} of {MP_PROCS} sharing the card, backend {g['backend']}: denoise "
              f"rows {r * b}-{(r + 1) * b - 1} of S={S_MAIN} F={F_MAIN} max|diff| {err:.3e} from "
              f"the one-process denoise_batch (tol {F32_TOL}); whisper-base rows {r * a}-"
              f"{(r + 1) * a - 1} of B={MP_ASR_B}, {MP_ASR_NEW} tokens equal {same}; "
              f"{MP_STEPS} DP steps against [17a]'s unsharded run: {check}; K1-K3 launches "
              f"{dict(zip(names, g['launches'].tolist()))}; host walls {walls} s (one process: "
              f"denoise {w_den:.3f}, whisper {w_asr:.3f}, training {want[3]:.3f} s; the ranks ran "
              f"beside 17a-17b, not a speed-up) [{card}]")
        if not err <= F32_TOL:
            fail(f"[17c] rank {r}: denoise rows differ by {err}")
        if not same:
            fail(f"[17c] rank {r}: tokens differ")
        if not all(np.array_equal(g[k], got[0][k]) for k in g if k.startswith("param:")):
            fail(f"[17c] rank {r}: parameters differ from rank 0's")
        if g["launches"].tolist() != [1, 1, 1]:
            fail(f"[17c] rank {r}: K1-K3 launched {g['launches']} times for one block")
        for name, c in zip(names, g["launches"].tolist()):
            launches[name] += c
    print(f"[17c] ranks' last lines: {[log.strip().splitlines()[-1] for log in logs]}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[17] 17a, 17b took {t1 - t0:.1f}, {t2 - t1:.1f} s; the ranks' wait after them "
          f"{t3 - t2:.1f} s, 17c's checks {time.perf_counter() - t3:.1f} s")
    return launches


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
    drill = DrillProcess()  # phase 13c's process, started while the smoke is small
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
    probe0 = (launch_us(torch), train_step_ms(torch, dev))
    print(f"[1] launch probe: {probe0[0]:.2f} us a launch ({PROBE_LAUNCHES} one-element adds, "
          f"host clock); training-step probe: {probe0[1]:.2f} ms a step (B={TRAIN_B}, "
          f"F={TRAIN_F}, median of {STEP_PROBE_STEPS})")

    # --- 2: kernels against their plain versions --------------------------
    with torch.no_grad():
        rows = kernel_phase(torch, pipeline, rk, ok, fk, params, dev)
        monitoring_shape_lines(torch, pipeline, rk, ok, fk, params, dev,
                               np.random.default_rng(SEED + 3))

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

    # --- 6 to 8: Whisper transcription ---------------------------------------
    wrng = np.random.default_rng(SEED + 2)
    whisper_files = contextlib.ExitStack()  # the ggml file and the phase-8 WAV (11c, 12, 15)
    tmp = whisper_files.enter_context(tempfile.TemporaryDirectory())
    with tempfile.TemporaryDirectory() as data:
        os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
        t0 = time.perf_counter()
        ggml = whisper_phase(torch, dev, Path(tmp), wrng)
        t1 = time.perf_counter()
        decode_phase(torch, dev, ggml, wrng, card)
        t2 = time.perf_counter()
        e2e_wav, e2e_manager, e2e_text, e2e_wall = e2e_phase(torch, dev, ggml, Path(tmp),
                                                             wrng, card)
        print(f"[8] phases 6, 7, 8 took {t1 - t0:.1f}, {t2 - t1:.1f}, "
              f"{time.perf_counter() - t2:.1f} s")

    # --- 9: live monitoring and recording ---------------------------------
    mrng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    graph_vs_eager(torch, pipeline, params, model, dev, mrng)
    with tempfile.TemporaryDirectory() as tmp:
        with spectra_path("off"):
            mon_launches = monitor_and_record(Path(tmp), mrng, kernels)
        for name in ("nn_scan", "rd_scan", "pitch_window_gather"):
            if mon_launches[name] < MON_SECONDS * 100:
                fail(f"kernel {name}: {mon_launches[name]} launches on the monitoring path for "
                     f"{MON_SECONDS * 100} frames")
        frame_latency(torch, pipeline, params, dev, mrng, card)
        config2(torch, dev, Path(tmp), mrng, card)
    print(f"[9] phase 9 took {time.perf_counter() - t0:.1f} s")
    for name, c in mon_launches.items():
        launches[name] += c

    # --- 10: the native ASR families ----------------------------------------
    from crispy_tpu_torch.models.registry import ModelManager

    t0 = time.perf_counter()
    ties: list = []
    arng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        with tempfile.TemporaryDirectory() as data:
            os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
            mm = ModelManager(models_dir=Path(tmp) / "Models")
            parakeet_cells(torch, mm, arng, card, ties)
            family_cells(torch, mm, arng, card, ties)
    print(f"[10] decisions that differ card vs CPU at a near-tie: {len(ties)} {ties}; "
          f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # --- 11: speaker diarization; 12: the ONNX executor ------------------------
    t0 = time.perf_counter()
    diar = diarization_phase(torch, dev, card, e2e_wav, e2e_manager)
    print(f"[11] phase 11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    onnx_files = contextlib.ExitStack()  # the 0.6b bundle (16c)
    onnx_kept = onnx_phase(torch, card, e2e_wav, onnx_files)
    print(f"[12] phase 12 took {time.perf_counter() - t0:.1f} s")

    # --- 13: the ONNX enc-dec bundles and the executor's diarization nets ------
    t0 = time.perf_counter()
    encdec_phase(torch, dev, card, drill)
    print(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s")

    # --- 14: RNNoise training ----------------------------------------------
    t0 = time.perf_counter()
    train_launches, corpus_model, corpus_losses = training_phase(torch, dev, card, kernels, probe0)
    for name, c in train_launches.items():
        launches[name] += c
    print(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")

    # --- 15: the served session ----------------------------------------------
    t0 = time.perf_counter()
    serve_launches = served_session(torch, card, kernels, e2e_wav)
    for name, c in serve_launches.items():
        launches[name] += c
    serve_cli_line()
    print(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s")

    # --- 16: one process over a list of devices (a mesh of the one card) -------
    from crispy_tpu_torch.parallel import make_mesh

    if make_mesh().devices.shape != (1, 1):
        fail("the mesh over the visible cards is not one card")
    t0 = time.perf_counter()
    mesh_launches = mesh_denoise(torch, pipeline, params, card, kernels)
    for name, c in mesh_launches.items():
        launches[name] += c
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as data:
        os.environ["CRISPY_DATA_DIR"] = data  # sidecars stay out of HOME
        mesh_whisper(torch, card, ggml, e2e_wav, e2e_manager, e2e_text, e2e_wall)
        t2 = time.perf_counter()
        mesh_onnx(torch, card, *onnx_kept)
    onnx_kept = None
    onnx_files.close()
    t3 = time.perf_counter()
    mesh_diarization(torch, card, diar)
    t4 = time.perf_counter()
    mesh_app(torch, card, ggml, e2e_wav)
    print(f"[16] 16a, 16b, 16c, 16d, 16e took {t1 - t0:.1f}, {t2 - t1:.1f}, {t3 - t2:.1f}, "
          f"{t4 - t3:.1f}, {time.perf_counter() - t4:.1f} s; phase 16 took "
          f"{time.perf_counter() - t0:.1f} s")

    # --- 17: training over a mesh, several processes on the card --------------
    t0 = time.perf_counter()
    mp_launches = multiprocess_phase(torch, pipeline, params, dev, card, kernels, ggml,
                                     (corpus_model, corpus_losses))
    for name, c in mp_launches.items():
        launches[name] += c
    whisper_files.close()
    print(f"[17] phase 17 took {time.perf_counter() - t0:.1f} s")

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank17c"]:
        sys.exit(rank_17c(Path(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
