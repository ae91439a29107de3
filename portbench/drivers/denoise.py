"""Batch denoising through the port's ``pipeline.denoise_batch``.

Each timed call denoises one piece of the traffic: ``streams`` recordings
of ``seconds_per_stream`` s at the configuration's rate, on the traffic's
wire (int16 PCM or float), in blocks of ``block_frames`` frames. The pieces
(``pool`` of them) are made on the card from the seed and copied to the
host in set-up; call i takes piece i mod pool.

The check: every call keeps ``kept_per_call`` output streams, the j-th of
call i from slice (i * kept + j) mod ``samples`` of the batch; after the
window one kept stream per slice (drawn from the seed) is held against the
NumPy reference run over the same input, which is made again from the seed.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import counts
from ..audio import speechlike, to_int16
from ..cells import check_entry, sub_seed
from ..reference import rnnoise as reference

FRAME = 480


class Driver:
    call_name = "denoise_batch"

    def __init__(self, cell, seed: int, device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.rate_metric = t["rate_metric"]
        self.rate = int(c["sample_rate"])
        self.S = int(t["streams"])
        self.samples = int(t["seconds_per_stream"] * self.rate)
        self.frames = self.samples // FRAME
        self.block_frames = int(t["block_frames"])
        self.wire = t["wire"]
        self.pool_n = int(t["pool"])
        self.n_samples = int(t["check"]["samples"])
        self.kept_per_call = int(t["check"]["kept_per_call"])
        self.items_per_call = self.S
        self.kept = []  # (call, row, output row)
        self.span_device_ms = {}
        self.stages = {}
        layers = {k: tuple(v) for k, v in c["layers"].items()}
        self.macs = counts.rnnoise_macs(layers)
        self.weight_floats = sum(i * o + o + (o // 3) * o * k.endswith("_gru") for k, (i, o) in layers.items())

    # -- set-up ------------------------------------------------------------------
    def setup(self) -> None:
        os.environ["CRISPY_FUSED_SPECTRA"] = "on" if self.cell.config["spectra_path"] == "fused" else "off"
        t = time.perf_counter()
        from crispy_tpu_torch.dsp.rnnoise import pipeline
        from crispy_tpu_torch.dsp.rnnoise.weights import RNNoiseModel

        self.stages["import the program"] = time.perf_counter() - t
        self.pipeline = pipeline
        t = time.perf_counter()
        model = RNNoiseModel.load(self.cell.path(self.cell.config["weights"]))
        self.params = pipeline.make_params(model, self.device)
        self.stages["params"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pool = [self._piece(p).cpu().numpy() for p in range(self.pool_n)]
        self.stages["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        self._denoise(self.pool[0])  # every block of a call has the window's shape
        self.stages["warm-up"] = time.perf_counter() - t

    def _piece(self, p: int) -> torch.Tensor:
        audio = speechlike(sub_seed(self.seed, "piece", p), self.S, self.samples, self.rate,
                           self.cell.traffic["audio"], self.device)
        return to_int16(audio) if self.wire == "i16" else audio

    def _denoise(self, x: np.ndarray) -> np.ndarray:
        return self.pipeline.denoise_batch(x, block_frames=self.block_frames, params=self.params,
                                           wire=self.wire, device=self.device)

    # -- the window ----------------------------------------------------------------
    def _row(self, i: int, j: int) -> int:
        q = (i * self.kept_per_call + j) % self.n_samples
        size = self.S // self.n_samples
        return q * size + sub_seed(self.seed, "keep", i, j) % size

    def call(self, i: int) -> float:
        out = self._denoise(self.pool[i % self.pool_n])
        for j in range(self.kept_per_call):
            r = self._row(i, j)
            self.kept.append((i, r, out[r].copy()))
        return self.S * self.samples / self.rate

    def units(self, calls: int) -> dict:
        return {"blocks": calls * -(-self.frames // self.block_frames),
                "frames": calls * self.S * self.frames}

    def flops_done(self, calls: int) -> float:
        return calls * self.S * self.frames * counts.rnnoise_frame_flops(self.macs)

    def kernel_bounds(self) -> dict:
        """Least seconds a launch, by a part of each kernel's name. K4 and K5
        share a kernel: one launch of each a block, so their mean."""
        c = counts.rnnoise_kernel_counts(self.S, self.block_frames, self.macs, self.weight_floats)
        b = {k: counts.bound_s(*v)[0] for k, v in c.items()}
        return {"nn_scan": b["nn_scan"], "rd_scan": b["rd_scan"], "pitch_gather": b["pitch_gather"],
                "spectrum_bands": (b["spectrum_bands.fwd"] + b["spectrum_bands.win"]) / 2,
                "inv_ola": b["inv_ola"]}

    def instrument(self, spans) -> None:
        step = "_denoise_block_i16" if self.wire == "i16" else "denoise_block"
        spans.wrap(self.pipeline, step, "block step")

    def release(self) -> None:
        self.params = self.pool = self.pipeline = None

    # -- the check ----------------------------------------------------------------
    def _sample(self):
        """One kept stream for each slice of the batch that the window kept."""
        by_slice = {}
        for i, r, out in self.kept:
            by_slice.setdefault(r // (self.S // self.n_samples), []).append((i, r, out))
        pick = []
        for q in sorted(by_slice):
            opts = by_slice[q]
            pick.append(opts[sub_seed(self.seed, "sample", q) % len(opts)])
        return pick

    def check(self, calls: int, control: bool = False) -> dict:
        pick = self._sample()
        rows = sorted({(i % self.pool_n, r) for i, r, _ in pick})
        inputs = []
        for p in sorted({p for p, _ in rows}):
            piece = self._piece(p)
            idx = [r for q, r in rows if q == p]
            inputs.append(piece[idx].cpu().numpy())
            del piece
        x = np.concatenate(inputs)
        w = reference.load_weights(self.cell.path(self.cell.config["weights"]))
        ref = reference.denoise(w, x, self.block_frames)
        where = {key: n for n, key in enumerate(rows)}
        got = np.stack([out for _, _, out in pick])
        want = ref[[where[(i % self.pool_n, r)] for i, r, _ in pick]]
        limits = self.cell.traffic["check"]["limits"]
        out = {k: check_entry(v, limits.get(k)) for k, v in self._numbers(got, want).items()}
        if control:
            ctl = reference.denoise(w, x, self.block_frames, tf32=True)
            ctl = ctl[[where[(i % self.pool_n, r)] for i, r, _ in pick]]
            out.update({f"control.{k}": check_entry(v, limits.get(k))
                        for k, v in self._numbers(ctl, want).items()})
            for side, y in (("program", got), ("control", ctl)):
                out.update({f"reading.{side}.{k}": check_entry(v, None)
                            for k, v in self.readings(y, want).items()})
        return out

    def _numbers(self, got: np.ndarray, want: np.ndarray) -> dict:
        """``frames_off_pct``: the share of the compared 480-sample frames in
        which some sample lies more than ``frame_tolerance_lsb`` int16 steps
        from the reference's (a float wire's samples scaled by 32768)."""
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        if got.dtype != np.int16:
            d *= 32768.0
        frames = d[:, : self.frames * FRAME].reshape(d.shape[0], self.frames, FRAME).max(axis=2)
        tol = self.cell.traffic["check"]["frame_tolerance_lsb"]
        return {"frames_off_pct": float(100.0 * np.mean(frames > tol))}

    @staticmethod
    def readings(got: np.ndarray, want: np.ndarray) -> dict:
        """Further readings of the same gap, for the record: the widest and
        RMS gap, and the frames off at other tolerances."""
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        n = d.shape[1] // FRAME
        frames = d[:, : n * FRAME].reshape(d.shape[0], n, FRAME).max(axis=2)
        out = {"worst_lsb": float(d.max()), "rms_lsb": float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))}
        out.update({f"frames_over_{t}_pct": float(100.0 * np.mean(frames > t)) for t in (1, 2, 3, 4, 8, 64)})
        return out
