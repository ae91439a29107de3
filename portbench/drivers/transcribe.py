"""Batched transcription through the port's ``WhisperModel``.

The model is built through the port's ``WhisperConfig`` and ``WhisperModel``
from weights that the benchmark draws on the card from the seed
(``reference.whisper.draw_weights``), handed over as the module's tensors.
Each timed call is ``transcribe_chunks_robust`` on one device-resident batch
of ``batch`` chunks of ``chunk_seconds`` s of 16 kHz speech-like audio; the
batches (``pool`` of them) are made on the card in set-up and call i takes
batch i mod pool.

The check: what the program's ``sample_decode`` returned (the served
tokens and the sum of their log-probabilities, kept by a wrapper on the
name the package calls) for one chunk of each of ``samples`` slices of the
batch, drawn from the seed over the window's calls, with the longest
served chunk among them. The reference runs once over each chunk with its
prompt and served tokens; two numbers are compared (``check``): the widest
gap between the program's and the reference's mean log-probability of the
served tokens, and the served tokens that are not the reference's first
choice by more than a rounding margin (greedy picks, exact).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .. import counts
from ..audio import speechlike
from ..cells import check_entry, sub_seed
from ..reference import whisper as reference


def _shape(c: dict) -> reference.Shape:
    return reference.Shape(
        n_mels=c["num_mel_bins"], n_vocab=c["vocab_size"], n_audio_ctx=c["max_source_positions"],
        d_model=c["d_model"], n_head=c["encoder_attention_heads"],
        encoder_layers=c["encoder_layers"], n_text_ctx=c["max_target_positions"],
        decoder_layers=c["decoder_layers"])


class Driver:
    call_name = "transcribe_chunks_robust"

    def __init__(self, cell, seed: int, device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.rate_metric = t["rate_metric"]
        self.shape = _shape(c)
        self.B = int(t["batch"])
        self.rate = int(t["sample_rate"])
        self.samples = int(t["chunk_seconds"] * self.rate)
        self.pool_n = int(t["pool"])
        self.max_new = int(t["max_new"])
        self.steps = self.max_new - 1  # cached steps a decode runs (EOS freezing: always all)
        self.n_samples = int(t["check"]["samples"])
        self.items_per_call = self.B
        self.served = []  # per timed call: (tokens [B, max_new], lengths [B], lp_sum [B])
        self.span_device_ms = {"encode": []}
        self.stages = {}
        self._enc_events = []

    # -- set-up ------------------------------------------------------------------
    def setup(self) -> None:
        c = self.cell.config
        os.environ["CRISPY_WHISPER_KV"] = {"bfloat16": "bf16", "float32": "f32"}[c["kv_cache_dtype"]]
        t = time.perf_counter()
        import crispy_tpu_torch.models.whisper as W

        self.stages["import the program"] = time.perf_counter() - t
        self.W = W
        s = self.shape
        cfg = W.WhisperConfig(s.n_mels, s.n_vocab, s.n_audio_ctx, s.d_model, s.n_head,
                              s.encoder_layers, s.n_text_ctx, s.d_model, s.n_head,
                              s.decoder_layers, c["eos_token_id"], c["decoder_start_token_id"])
        tok = W.WhisperTokenizer(vocab=[f"<{i}>".encode() for i in range(s.n_vocab)],
                                 multilingual=True, num_languages=c["num_languages"])
        t = time.perf_counter()
        weights = reference.draw_weights(s, sub_seed(self.seed, "weights"), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stages["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        with _module_from(W, weights):
            self.wm = W.WhisperModel(weights, cfg, tok, name=self.cell.config_name, device=self.device)
        del weights
        self.stages["WhisperModel"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pool = [self._batch(p) for p in range(self.pool_n)]
        self.stages["inputs"] = time.perf_counter() - t
        self._keep = W.sample_decode
        W.sample_decode = self._served(W.sample_decode)
        t = time.perf_counter()
        self._transcribe(self.pool[0])  # every shape of the window's calls
        self.stages["warm-up"] = time.perf_counter() - t
        self.served.clear()

    def _batch(self, p: int) -> torch.Tensor:
        return speechlike(sub_seed(self.seed, "batch", p), self.B, self.samples, self.rate,
                          self.cell.traffic["audio"], self.device)

    def _served(self, fn):
        def sample_decode(*a, **k):
            out = fn(*a, **k)
            self.served.append((out[0], out[1], out[2]))
            return out
        return sample_decode

    def _transcribe(self, chunks):
        t = self.cell.traffic
        return self.wm.transcribe_chunks_robust(chunks, language=t["language"], max_new=self.max_new,
                                                temperatures=tuple(t["temperatures"]))

    # -- the window ----------------------------------------------------------------
    def call(self, i: int) -> float:
        self._transcribe(self.pool[i % self.pool_n])
        return self.B * self.samples / self.rate

    def units(self, calls: int) -> dict:
        return {"decode_steps": calls * self.steps, "chunks": calls * self.B}

    def flops_done(self, calls: int) -> float:
        s, prompt = self.shape, len(self.cell.config["prompt"])
        return calls * self.B * counts.whisper_chunk_flops(
            s.n_mels, s.d_model, s.encoder_layers, s.decoder_layers, s.n_vocab, prompt, self.steps)

    def kernel_bounds(self) -> dict:
        return {}

    def instrument(self, spans) -> None:
        W = self.W

        def enc_start():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._enc_events.append([e, None])

        def enc_end(_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._enc_events[-1][1] = e

        def idle_mark(_):
            torch.cuda.synchronize()
            spans.mark()

        spans.wrap(W, "encode", "encode", before=enc_start, after=enc_end)
        spans.wrap(W, "sample_decode", "decode loop", after=idle_mark)

    def release(self) -> None:
        self.span_device_ms["encode"] = [a.elapsed_time(b) for a, b in self._enc_events if b is not None]
        self.W.sample_decode = self._keep
        self.served = [tuple(x.cpu() for x in call) for call in self.served]
        self.wm = self.pool = self.W = None

    # -- the check ----------------------------------------------------------------
    def _sample(self):
        """(call, row) for one chunk of each slice of the batch, drawn from
        the seed over the window's calls; the longest served chunk replaces
        the draw of its slice."""
        calls = len(self.served)
        size = self.B // self.n_samples
        pick = {q: (sub_seed(self.seed, "sample", q) % calls,
                    q * size + sub_seed(self.seed, "row", q) % size) for q in range(self.n_samples)}
        longest = max(((i, b) for i in range(calls) for b in range(self.B)),
                      key=lambda ib: int(self.served[ib[0]][1][ib[1]]))
        pick[longest[1] // size] = longest
        return [pick[q] for q in sorted(pick)]

    def _logits(self, ref, audio, tokens):
        """The reference's logits at the position of each served token:
        one pass over the prompt and the served tokens."""
        prompt = torch.tensor(self.cell.config["prompt"], device=self.device)
        inp = torch.cat([prompt, tokens[:-1]])[None]
        return ref.logits(audio[None], inp)[0, prompt.shape[0] - 1:]

    def check(self, calls: int, control: bool = False) -> dict:
        """Over the sampled chunks: ``logprob_gap``, the widest gap between
        the mean log-probability of the served tokens that the program's
        decode returned (its ``sum_logprob``, the numerator of the fallback
        ladder's average) and the reference's for the same tokens; and
        ``wrong_picks``, the served tokens whose logit lies below the
        reference's best by more than ``tie`` (a greedy pick is the
        reference's first choice wherever its lead is clear of rounding).
        With ``control``, the control's reading of both, and further
        readings for the record: the widest token gap of the program, the
        control's widest logit error against the reference, and the
        reference's narrowest lead of its first choice over its second."""
        pick = self._sample()
        tie = self.cell.traffic["check"]["tie"]
        weights = reference.draw_weights(self.shape, sub_seed(self.seed, "weights"), self.device)
        batches = {p: self._batch(p) for p in sorted({i % self.pool_n for i, _ in pick})}
        ref = reference.Reference(self.shape, weights)
        ctl = reference.Reference(self.shape, weights, tf32=True) if control else None
        lp_gap = tok_gap = c_lp_gap = c_logit_err = 0.0
        wrong = c_wrong = 0
        lead = float("inf")
        with torch.no_grad():
            for i, b in pick:
                tokens, length, lp_sum = (x[b] for x in self.served[i])
                n = min(int(length) + 1, tokens.shape[0])  # through the first eot
                toks = tokens[:n].to(self.device)
                audio = batches[i % self.pool_n][b]
                lg = self._logits(ref, audio, toks)
                lp_ref = torch.log_softmax(lg.double(), -1).gather(-1, toks[:, None]).sum()
                lp_gap = max(lp_gap, abs(float(lp_sum) - float(lp_ref)) / n)
                best = lg.max(-1).values
                gap = best - lg.gather(-1, toks[:, None])[:, 0]
                wrong += int((gap > tie).sum())
                tok_gap = max(tok_gap, float(gap.max()))
                if ctl is not None:
                    top2 = lg.topk(2, dim=-1).values
                    lead = min(lead, float((top2[:, 0] - top2[:, 1]).min()))
                    cl = self._logits(ctl, audio, toks)
                    lp_ctl = torch.log_softmax(cl.double(), -1).gather(-1, toks[:, None]).sum()
                    c_lp_gap = max(c_lp_gap, abs(float(lp_ctl) - float(lp_ref)) / n)
                    c_logit_err = max(c_logit_err, float((cl - lg).abs().max()))
                    c_gap = best - lg.gather(-1, cl.argmax(-1)[:, None])[:, 0]
                    c_wrong += int((c_gap > tie).sum())
        limits = self.cell.traffic["check"]["limits"]
        out = {"logprob_gap": check_entry(lp_gap, limits.get("logprob_gap")),
               "wrong_picks": check_entry(wrong, limits.get("wrong_picks"))}
        if control:
            out["control.logprob_gap"] = check_entry(c_lp_gap, limits.get("logprob_gap"))
            out["control.wrong_picks"] = check_entry(c_wrong, limits.get("wrong_picks"))
            out["reading.program.token_gap"] = check_entry(tok_gap, None)
            out["reading.control.logit_err"] = check_entry(c_logit_err, None)
            out["reading.reference.lead"] = check_entry(lead, None)
        return out


@contextlib.contextmanager
def _module_from(W, weights):
    """``WhisperModel`` carries flat NumPy parameters into its module with
    ``params_to_module``; for the duration, that name takes the benchmark's
    device tensors (named as the module's state) as they are."""
    keep = W.params_to_module

    def params_to_module(params, cfg, device):
        with torch.device("meta"):
            m = W.Whisper(cfg)
        m.load_state_dict(params, strict=True, assign=True)
        return m.eval().requires_grad_(False)

    W.params_to_module = params_to_module
    try:
        yield
    finally:
        W.params_to_module = keep
