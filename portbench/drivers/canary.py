"""Batched transcription through the port's canary engine.

The model is the program's ``Canary`` at the widths of its ``CONFIGS``
entry named by the configuration file (``config``), which must equal the
file's own widths; its weights are drawn on the card from the seed
(``reference.canary.draw_weights``) and handed over as the module's
tensors. The engine is the program's ``CanaryEngine`` over that module, a
SentencePiece vocabulary of the configuration's size with its special
tokens, and its prompt. Each timed call is ``transcribe_batch`` on one
device-resident batch of ``batch`` chunks of ``chunk_seconds`` s of 16 kHz
speech-like audio; the batches (``pool`` of them) are made on the card in
set-up and call i takes batch i mod pool.

The check: what the timed path served, kept by wrappers on the names the
program calls (``greedy_decode`` and the call of its ``DecodeStep``): the
tokens, and the sum of the log-probabilities of the served tokens through
the first eos under the logits each step returned (the wrappers keep a
copy of each step's logits for the length of a call and reduce them once
at its end).
For one chunk of each of ``samples`` slices of the batch, drawn from the
seed over the window's calls, with the longest served chunk among them, the
reference runs once over the chunk with its prompt and served tokens; two
numbers are compared, as in the Whisper cell: the widest gap between the
program's and the reference's mean log-probability of the served tokens
(``logprob_gap``), and the served tokens that are not the reference's
first choice by more than a rounding margin (``wrong_picks``). The draw of
the chunks and the reference's pass over one are the Whisper cell's own.
"""

from __future__ import annotations

import inspect
import time

import torch

from .. import counts_canary
from ..audio import speechlike
from ..cells import check_entry, sub_seed
from ..reference import canary as reference
from . import transcribe


def _widths(cfg) -> dict:
    """The program's configuration as the reference's shape fields."""
    e = cfg.encoder
    return dict(n_mels=e.n_mels, d_model=e.hidden_size, enc_layers=e.layers, enc_heads=e.heads,
                enc_ffn=e.intermediate_size, conv_kernel=e.conv_kernel,
                sub_channels=e.sub_channels, sub_factor=e.sub_factor, dec_layers=cfg.dec_layers,
                dec_heads=cfg.dec_heads, dec_ffn=cfg.dec_ffn, n_vocab=cfg.vocab_size,
                max_len=cfg.max_len)


def vocabulary(c: dict):
    """(pieces, types) of a SentencePiece vocabulary of the configuration's
    size: its special tokens at their ids, ``▁t<i>`` elsewhere."""
    from crispy_tpu_torch.models.spm import CONTROL, NORMAL, UNKNOWN

    pieces = [f"▁t{i}" for i in range(c["vocab_size"])]
    types = [NORMAL] * c["vocab_size"]
    for piece, i in c["special_tokens"].items():
        pieces[i], types[i] = piece, UNKNOWN if piece == "<unk>" else CONTROL
    return pieces, types


class Driver:
    call_name = "transcribe_batch"

    def __init__(self, cell, seed: int, device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.rate_metric = t["rate_metric"]
        self.shape = reference.shape_of(c)
        self.B = int(t["batch"])
        self.rate = int(t["sample_rate"])
        self.samples = int(t["chunk_seconds"] * self.rate)
        self.pool_n = int(t["pool"])
        self.max_new = int(t["max_new"])
        self.steps = self.max_new - 1  # cached steps a decode runs (EOS freezing: always all)
        self.prompt = [int(i) for i in c["prompt"]]
        self.n_samples = int(t["check"]["samples"])
        self.items_per_call = self.B
        self.served = []  # per timed call: (tokens [B, max_new], lengths [B], lp_sum [B])
        self.span_device_ms = {}
        self.stages = {}
        self._mark = None
        self._kept = []

    # -- set-up ------------------------------------------------------------------
    def setup(self) -> None:
        c = self.cell.config
        t = time.perf_counter()
        import crispy_tpu_torch.models.canary as cn
        from crispy_tpu_torch.engine.transcription import CanaryEngine
        from crispy_tpu_torch.models.spm import SentencePieceVocab

        self.stages["import the program"] = time.perf_counter() - t
        cfg = cn.CONFIGS[c["config"]]
        if reference.Shape(**_widths(cfg)) != self.shape or cfg.eos != c["eos_token_id"]:
            raise ValueError(f"CONFIGS[{c['config']!r}] differs from {self.cell.config_name}'s file")
        default = inspect.signature(cn.greedy_decode).parameters["max_new"].default
        if default != self.max_new:
            raise ValueError(f"the engine decodes {default} tokens, the traffic asks for {self.max_new}")
        self.cn = cn
        t = time.perf_counter()
        weights = reference.draw_weights(self.shape, sub_seed(self.seed, "weights"), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stages["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        with torch.device("meta"):
            net = cn.Canary(cfg)
        net.load_state_dict(weights, strict=True, assign=True)
        del weights
        self.engine = CanaryEngine(self.cell.config_name, net.eval().requires_grad_(False),
                                   SentencePieceVocab(*vocabulary(c)), self.prompt, self.device)
        self.stages["CanaryEngine"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pool = [self._batch(p) for p in range(self.pool_n)]
        self.stages["inputs"] = time.perf_counter() - t
        self._kept = [(cn, "greedy_decode", cn.greedy_decode),
                      (cn.DecodeStep, "__call__", cn.DecodeStep.__call__)]
        self._serve(cn)
        t = time.perf_counter()
        self._transcribe(self.pool[0])  # every shape of the window's calls
        self.stages["warm-up"] = time.perf_counter() - t
        self.served.clear()

    def _batch(self, p: int) -> torch.Tensor:
        return speechlike(sub_seed(self.seed, "batch", p), self.B, self.samples, self.rate,
                          self.cell.traffic["audio"], self.device)

    def _serve(self, cn) -> None:
        """Wrap the decode loop and its step: a copy of each step's logits
        (on the card the step's output buffer, which the next step
        overwrites) is kept for the call, then the served tokens'
        log-probabilities summed."""
        decode, step = cn.greedy_decode, cn.DecodeStep.__call__
        logits = []

        def __call__(self_, tok, pos):
            out = step(self_, tok, pos)
            logits.append(out.clone())
            return out

        def greedy_decode(model, mel, max_new=self.max_new, prompt=None):
            logits.clear()
            tokens, lengths = decode(model, mel, max_new=max_new, prompt=prompt)
            P = 1 if prompt is None else prompt.shape[1]
            lp = torch.log_softmax(torch.stack(logits[P - 1:], dim=1), dim=-1)
            lp = lp.gather(-1, tokens[..., None])[..., 0]
            served = torch.arange(tokens.shape[1], device=tokens.device) <= lengths[:, None]
            self.served.append((tokens, lengths, torch.where(served, lp, 0.0).sum(-1)))
            logits.clear()
            return tokens, lengths

        cn.DecodeStep.__call__, cn.greedy_decode = __call__, greedy_decode

    def _transcribe(self, chunks):
        return self.engine.transcribe_batch(chunks, language=self.cell.traffic["language"])

    # -- the window ----------------------------------------------------------------
    def call(self, i: int) -> float:
        self._transcribe(self.pool[i % self.pool_n])
        if self._mark is not None:
            self._mark()  # the card is idle: the call ended reading its tokens back
        return self.B * self.samples / self.rate

    def units(self, calls: int) -> dict:
        return {"decode_steps": calls * self.steps, "chunks": calls * self.B}

    def flops_done(self, calls: int) -> float:
        return calls * counts_canary.call_flops(self.shape, self.B, self.samples,
                                                len(self.prompt), self.steps)

    def kernel_bounds(self) -> dict:
        return {}

    def instrument(self, spans) -> None:
        if self.device.type == "cuda":
            self._mark = spans.mark

    def release(self) -> None:
        for module, attr, fn in self._kept:
            setattr(module, attr, fn)
        self._kept = []
        self._mark = None
        self.served = [tuple(x.cpu() for x in call) for call in self.served]
        self.engine = self.pool = self.cn = None

    # -- the check ----------------------------------------------------------------
    _sample = transcribe.Driver._sample
    _logits = transcribe.Driver._logits

    def check(self, calls: int, control: bool = False) -> dict:
        """Over the sampled chunks: ``logprob_gap``, the widest gap between
        the mean log-probability of the served tokens under the program's
        step logits and under the reference's; and ``wrong_picks``, the
        served tokens whose logit lies below the reference's best by more
        than ``tie``. With ``control``, the control's reading of both, and
        further readings for the record: the widest token gap of the
        program, the control's widest logit error against the reference,
        and the reference's narrowest lead of its first choice over its
        second."""
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
                n = min(int(length) + 1, tokens.shape[0])  # through the first eos
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
