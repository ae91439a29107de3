"""The streaming block step as a captured CUDA graph (the port's counterpart
of the JAX package's ``_denoise_block_jit``, which compiles the step into one
program).

Live monitoring runs ``pipeline.denoise_block`` on one stream, one 480-sample
frame at a time, once per 10 ms of audio. Eagerly that is about a thousand
small launches per frame, each paying the host's launch cost; ``GraphedBlockStep``
records the whole step once and replays it with one launch per frame.

  * Capture per spectra path: the step reads ``CRISPY_FUSED_SPECTRA`` at
    every call, as ``denoise_block`` does, and captures that path's graph the
    first time it sees it (the current path at construction). Before a
    capture it warms the step up on a side stream, on a clone of the state,
    so the kernels, cuFFT plans, K1's packed fp16 weights and the FFT
    twiddles exist before capture; the capture itself executes nothing, so
    the live state is never advanced by either.
  * The graph ends by copying each new state tensor into its static buffer
    (``denoise_block`` rebinds them to new tensors), so a replay carries the
    state exactly as an eager call does.
  * The graph holds raw pointers that PyTorch does not keep alive for it:
    the parameters, K1's packed weights (``rnn_kernels._HALF_WEIGHTS`` keeps
    one parameter set per device and would free them when another set is
    used) and the twiddle table. The step holds them.
  * The kernel wrappers count launches in Python, which a replay does not
    run: the counts a capture added are taken back and added once per
    replay.
  * Replays run on the step's own high-priority stream, so work queued on
    the default stream (a batch job) does not delay a live frame; the output
    comes back through a pinned buffer and only that stream is synchronised.
  * A failed capture or replay raises; the step never falls back to the
    eager path on the card. On the CPU it simply calls ``denoise_block``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...device import resolve_device
from . import frontend_kernels as fk
from . import ops_kernels as ok
from . import pipeline
from . import rnn_kernels as rk

# every kernel wrapper's launch counter: (wrapper, attribute)
COUNTERS = ((rk.nn_scan, "launches"), (rk.nn_scan, "launches_f32"),
            (rk.rd_scan, "launches"), (ok.pitch_window_gather, "launches"),
            (fk.fwd_spectrum_bands, "launches"), (fk.win_spectrum_bands, "launches"),
            (fk.inv_spectrum_ola, "launches"))
_WARMUP_STEPS = 2


def _counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


class GraphedBlockStep:
    """``denoise_block`` on [n_streams, frames * 480] blocks, replayed from a
    CUDA graph on the card. ``step(x)`` takes a host block (numpy or a CPU
    tensor) and returns the output block as a CPU tensor; ``state`` is the
    carried state (static buffers on the card)."""

    def __init__(self, params: Dict[str, torch.Tensor], n_streams: int = 1,
                 frames: int = 1, device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if any(p.device != dev for p in params.values()):
            raise ValueError(f"params must lie on {dev}")
        self.device = dev
        self.params = params
        self.shape = (n_streams, frames * pipeline.FRAME)
        self.state = pipeline.init_state(n_streams, dev)
        if dev.type != "cuda":
            return
        self._stream = torch.cuda.Stream(dev, priority=-1)
        self._x = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        self._out = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        self._x_host = torch.zeros(self.shape, dtype=torch.float32, pin_memory=True)
        self._out_host = torch.zeros(self.shape, dtype=torch.float32, pin_memory=True)
        self._graphs: Dict[bool, tuple] = {}  # fused -> (graph, launch counts per replay)
        self._keep = [tuple(params.values())]  # tensors whose addresses a graph holds
        self._capture(pipeline._use_fused_spectra())

    def _capture(self, fused: bool) -> None:
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad():
            with torch.cuda.stream(s):
                scratch = {k: v.clone() for k, v in self.state.items()}
                for _ in range(_WARMUP_STEPS):
                    scratch, _, _ = pipeline.denoise_block(self.params, scratch, self._x)
            s.synchronize()
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=s, capture_error_mode="thread_local"):
                    new, out, _ = pipeline.denoise_block(self.params, self.state, self._x)
                    for k, buf in self.state.items():
                        buf.copy_(new[k])
                    self._out.copy_(out)
            finally:
                after = _counts()
                for (fn, attr), c in zip(COUNTERS, before):
                    setattr(fn, attr, c)  # the capture launched nothing
        self._keep.append(rk._half_weights(self.params))
        if fused:
            self._keep.append(fk._twiddles_on(self.device))
        self._graphs[fused] = (graph, [a - b for a, b in zip(after, before)])

    def step(self, x) -> torch.Tensor:
        xt = torch.as_tensor(np.asarray(x, dtype=np.float32)).reshape(self.shape)
        if self.device.type != "cuda":
            with torch.no_grad():
                self.state, out, _ = pipeline.denoise_block(self.params, self.state, xt)
            return out
        fused = pipeline._use_fused_spectra()
        if fused not in self._graphs:
            self._capture(fused)
        graph, deltas = self._graphs[fused]
        self._x_host.copy_(xt)
        with torch.cuda.stream(self._stream):
            self._x.copy_(self._x_host, non_blocking=True)
            graph.replay()
            self._out_host.copy_(self._out, non_blocking=True)
        self._stream.synchronize()
        for (fn, attr), d in zip(COUNTERS, deltas):
            setattr(fn, attr, getattr(fn, attr) + d)
        return self._out_host.clone()
