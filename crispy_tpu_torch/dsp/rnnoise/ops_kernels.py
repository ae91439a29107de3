"""The pipeline's irregular reads (the port of ``pallas_ops.py``).

  pitch_window_gather  — K3: per (stream, frame), the 960-sample window of the
                         HP history at a data-dependent start; the CUDA kernel
                         ``csrc/pitch_gather.cu`` on the card, its plain
                         version on the CPU, ``.launches`` counts launches.
  rd_candidate_gather  — remove_doubling's reads at the 15 candidate periods,
                         a ``torch.gather`` (plain XLA in the JAX package, not
                         a Pallas kernel).
"""

from __future__ import annotations

import torch

from ... import _build
from .constants import WINDOW_SIZE as WIN
from .rnn_kernels import _on_card, _require


def pitch_window_gather_reference(ext: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ext [S, L], starts [S, F] int32 → [S, F, 960] with
    out[s, f] = ext[s, st : st + 960]. ``lax.dynamic_slice`` semantics: a
    negative start counts from the end (st + L), then st is clamped to
    [0, L - 960]. The pipeline's starts are always in range."""
    S, L = ext.shape
    st = starts.to(torch.int64)
    st = torch.where(st < 0, st + L, st).clamp(0, L - WIN)
    idx = st[..., None] + torch.arange(WIN, device=ext.device)
    rows = torch.arange(S, device=ext.device)[:, None, None]
    return ext[rows, idx]


def pitch_window_gather(ext: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """K3, the counterpart of ``pallas_ops.pitch_window_gather``."""
    if not _on_card(ext, starts):
        return pitch_window_gather_reference(ext, starts)
    S, L = ext.shape
    F = starts.shape[1]
    if S == 0 or F == 0 or L < WIN:
        raise ValueError(f"pitch_window_gather: need S, F > 0 and L >= {WIN}, got "
                         f"S={S} F={F} L={L}")
    _require(ext, "ext", torch.float32, (S, L))
    _require(starts, "starts", torch.int32, (S, F))
    dev = ext.device
    out = torch.empty((S, F, WIN), dtype=torch.float32, device=dev)
    lib = _build.load()
    rc = lib.crispy_pitch_gather(ext.data_ptr(), starts.data_ptr(), out.data_ptr(), S, L, F,
                                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pitch_window_gather")
    pitch_window_gather.launches += 1
    return out


pitch_window_gather.launches = 0


def _rd_candidates(T0: torch.Tensor, second_check: torch.Tensor):
    """Candidate periods per frame: T_cand [.., 15] and the second-check
    periods T_bcand [.., 15] (remove_doubling's k-subharmonic table)."""
    ks = torch.arange(2, 16, dtype=T0.dtype, device=T0.device)
    T0k = T0[..., None]
    T1 = (2 * T0k + ks) // (2 * ks)
    sc = second_check.to(T0.dtype)[2:16]
    T1b = torch.where(ks == 2, torch.where(T0k + T1 > 384, T0k, T0k + T1),
                      (2 * sc * T0k + ks) // (2 * ks))
    tcand = torch.cat([T0k, T1], dim=-1)
    tbcand = torch.cat([T0k, T1b], dim=-1)
    return tcand, tbcand


def rd_candidate_gather(corr: torch.Tensor, yyl: torch.Tensor, T0: torch.Tensor,
                        second_check: torch.Tensor):
    """corr/yyl [S, F, 385], T0 [S, F] int → (xy_t [S, F, 15], xc_m1, xc_p1,
    yy_t, xy_tb, yy_tb) at the 15 candidates: c=0 is T0, c>=1 are the
    k=2..15 subharmonics with their second-check periods."""
    L = corr.shape[-1]
    tcand, tbcand = _rd_candidates(T0.to(torch.int64), second_check)

    def take(arr, idx):
        return torch.gather(arr, -1, idx.clamp(0, L - 1))

    return (take(corr, tcand), take(corr, tcand - 1), take(corr, tcand + 1),
            take(yyl, tcand), take(corr, tbcand), take(yyl, tbcand))
