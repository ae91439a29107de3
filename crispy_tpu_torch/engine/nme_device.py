"""NME-SC spectral clustering on the device.

The port of ``crispy_tpu/engine/nme_device.py`` (reference algorithm:
src-tauri/src/managers/diarization.rs:422-611, Park et al. 2019). Cosine
affinity, top-p row pruning, the p-sweep of pruned-Laplacian eigenvalues,
connectivity, the spectral embedding, farthest-point k-means and the
separation check all run on the device the embeddings are sent to; one
[n] label vector comes back.

  * n is padded to the JAX package's bucket (``_bucket``) and the subspace
    iteration starts from its basis (``_start_basis``, which depends on
    the bucket), so both packages iterate from the same vectors. Pad rows
    are masked everywhere and their Laplacian diagonal is 3.0, above the
    [0, 2] spectrum of a normalized Laplacian, so they never enter the
    smallest-k eigenvalues.
  * The sweep over p runs as batched ``matmul``, ``linalg.qr`` and
    ``linalg.eigvalsh`` over [_SWEEP_BATCH, N, N] stacks, as
    ``lax.map(batch_size=16)`` does in the JAX package.
  * Connectivity is ⌈log2 N⌉ squarings of the {0, 1} matrix (A | I): exact
    in f32 with TF32 off (``device.resolve_device`` turns it off).

Eigenvector signs, and the basis inside a repeated eigenvalue, differ
between cuSOLVER, LAPACK and XLA; distances between row-normalised
spectral rows do not, so the labels agree with the JAX package's up to
relabelling.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device

_SWEEP_BATCH = 16  # p values a batched sweep step holds ([16, N, N] each)

# Buckets of this size or more take the bottom KMAX+1 eigenvalues of each
# swept Laplacian by subspace iteration (all the sweep reads) instead of a
# full eigvalsh; below it eigvalsh is cheap.
_SUBSPACE_MIN_N = 512
_SUBSPACE_ITERS = 48
_SUBSPACE_MAX_DIM = 64  # eigvalsh when KMAX+2 exceeds this

# The speaker count at the chosen p* comes from a more accurate pass: S=32
# vectors, 96 iterations (the sweep's S=16/48 Ritz values are biased by up
# to ~2e-2 on adversarial spectra; tests/test_nme_eigengap.py pins both).
_FINAL_SUB = 32
_FINAL_ITERS = 96


@functools.lru_cache(maxsize=8)
def _start_basis(N: int, S: int) -> np.ndarray:
    """The subspace iteration's start basis: the JAX package's draws
    (NumPy ``default_rng(0)``), so both packages start from the same
    vectors for the same bucket."""
    return np.random.default_rng(0).standard_normal((N, S)).astype(np.float32)


def subspace_bottom(L: torch.Tensor, s_sub: int, iters: int = _SUBSPACE_ITERS):
    """Bottom-s_sub eigenpairs of padded normalized Laplacians [..., N, N] by
    subspace iteration on M = 3I − L (the real block's spectrum lies in
    [0, 2]; pad rows sit at exactly 3, so M sends them to 0).

    Returns (ascending eigenvalues [..., s_sub], Ritz vectors [..., N, s_sub]).
    Ritz values bound the true eigenvalues from above."""
    N = L.shape[-1]
    V = torch.from_numpy(_start_basis(N, s_sub)).to(L.device)
    M = 3.0 * torch.eye(N, dtype=torch.float32, device=L.device) - L
    V = V.expand(*L.shape[:-2], N, s_sub)
    for _ in range(iters):
        V = torch.linalg.qr(torch.matmul(M, V))[0]
    T = torch.matmul(V.transpose(-1, -2), torch.matmul(M, V))
    mu, W = torch.linalg.eigh(T)  # ascending in mu = 3 - lambda
    lam = (3.0 - mu).flip(-1)
    vecs = torch.matmul(V, W).flip(-1)
    return lam, vecs


def _bucket(n: int, lo: int = 8) -> int:
    """Power of two up to 256, then multiples of 256 (the JAX package's
    buckets)."""
    b = lo
    while b < n and b < 256:
        b *= 2
    if b >= n:
        return b
    return -(-n // 256) * 256


def _p_cap(n: int) -> int:
    """The sweep's bound p_max = min(n−1, max(⌊√n⌋, 2)·2)."""
    return int(min(n - 1, max(int(np.sqrt(n)), 2) * 2))


def _laplacian(a: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Symmetric normalized Laplacian of pruned affinities [..., N, N] (zero
    diagonal, zero pad rows); pad nodes get eigenvalue 3.0."""
    N = a.shape[-1]
    dinv = 1.0 / torch.sqrt(torch.clamp(a.sum(-1), min=1e-9))
    lap = torch.eye(N, dtype=torch.float32, device=a.device) - (
        dinv[..., :, None] * a * dinv[..., None, :])
    pad_diag = torch.diag(~valid)
    return torch.where(pad_diag, torch.tensor(3.0, device=a.device), lap)


def _connected(a: torch.Tensor, valid: torch.Tensor, n_sq: int) -> torch.Tensor:
    """Whether every valid node is reachable from node 0, for each pruned
    graph [..., N, N]: n_sq squarings of (A | I) as {0, 1} f32 matrices."""
    N = a.shape[-1]
    m = ((a > 0.0) | torch.diag(valid)).float()
    for _ in range(n_sq):
        m = (torch.matmul(m, m) > 0.0).float()
    return torch.where(valid, m[..., 0, :] > 0.0, True).all(-1)


def _eigengap(ev: torch.Tensor, kmax: int, KMAX: int):
    """Host rule on ascending eigenvalues [..., ≥KMAX+1]: the first largest
    gap ev[i] − ev[i−1] over i in 1..kmax, k floor 1, gap floor 0."""
    gaps = ev[..., 1:KMAX + 1] - ev[..., :KMAX]
    idx = torch.arange(1, KMAX + 1, device=ev.device)
    gaps = torch.where(idx <= kmax, gaps, -math.inf)
    bi = torch.argmax(gaps, dim=-1)
    best = torch.gather(gaps, -1, bi[..., None])[..., 0]
    return torch.clamp(bi + 1, min=1), torch.clamp(best, min=0.0)


def _kmeans(points: torch.Tensor, k: torch.Tensor, valid: torch.Tensor, KMAX: int):
    """Farthest-point seeding from point 0, then 50 Lloyd iterations with
    KMAX center slots (slots ≥ k masked): the JAX package's device k-means."""
    dev = points.device
    slots = torch.arange(KMAX, device=dev)
    centers = torch.zeros((KMAX, KMAX), dtype=torch.float32, device=dev)
    centers[0] = points[0]
    for c in range(1, KMAX):
        d = ((points[:, None, :] - centers[None]) ** 2).sum(-1)
        dmin = torch.where((slots < c)[None, :], d, math.inf).amin(1)
        nxt = torch.argmax(torch.where(valid, dmin, -1.0))
        centers[c] = torch.where(c < k, points[nxt], centers[c])
    labels = torch.zeros(points.shape[0], dtype=torch.long, device=dev)
    for _ in range(50):
        d = ((points[:, None, :] - centers[None]) ** 2).sum(-1)
        d = torch.where((slots < k)[None, :], d, math.inf)
        labels = torch.argmin(d, dim=1)
        onehot = ((labels[:, None] == slots[None, :]) & valid[:, None]).float()
        cnt = onehot.sum(0)
        sums = torch.matmul(onehot.T, points)
        centers = torch.where(cnt[:, None] > 0,
                              sums / torch.clamp(cnt, min=1.0)[:, None], centers)
    return labels


def _use_subspace(N: int, KMAX: int) -> bool:
    return N >= _SUBSPACE_MIN_N and max(16, KMAX + 2) <= _SUBSPACE_MAX_DIM


def _graph(emb: torch.Tensor, n: int):
    """Cosine affinities of the first n rows of bucket-padded embeddings
    [N, D] (zero diagonal, zero pad and zero-norm rows), each column's
    descending rank in its row, and the valid-row mask."""
    N = emb.shape[0]
    ii = torch.arange(N, device=emb.device)
    valid = ii < n
    norms = torch.sqrt((emb * emb).sum(1))
    normed = emb / torch.clamp(norms, min=1e-12)[:, None]
    aff = torch.clamp(torch.matmul(normed, normed.T), 0.0, 1.0)
    keepable = (valid[:, None] & valid[None, :] & (norms > 0)[:, None]
                & (norms > 0)[None, :] & (ii[:, None] != ii[None, :]))
    aff = torch.where(keepable, aff, 0.0)
    # stable: equal affinities keep ascending column order (the host's
    # stable sort); self/invalid sort last
    order = torch.argsort(-torch.where(keepable, aff, -1.0), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return aff, rank, valid


def _pruned(aff: torch.Tensor, rank: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """Top-p pruned affinities for each p [...] → [..., N, N], symmetrized by max."""
    keep = torch.clamp(p, max=n - 1)[..., None, None]
    a = torch.where(rank < keep, aff, 0.0)
    return torch.maximum(a, a.transpose(-1, -2))


def _sweep(aff, rank, valid, n: int, kmax: int, KMAX: int, P: int):
    """For p = 1..P: the NME ratio (p/n)/eigengap, the graph's connectivity
    and its speaker count, _SWEEP_BATCH values of p a batched step."""
    N = aff.shape[0]
    n_sq = int(np.ceil(np.log2(max(N, 2))))
    use_subspace = _use_subspace(N, KMAX)
    ps = torch.arange(1, P + 1, device=aff.device)
    ratios, conns, ks = [], [], []
    for s in range(0, P, _SWEEP_BATCH):
        p = ps[s:s + _SWEEP_BATCH]
        a = _pruned(aff, rank, n, p)
        lap = _laplacian(a, valid)
        ev = (subspace_bottom(lap, max(16, KMAX + 2))[0] if use_subspace
              else torch.linalg.eigvalsh(lap))
        k_p, gap = _eigengap(ev, kmax, KMAX)
        ratios.append((p.float() / n) / torch.clamp(gap, min=1e-6))
        conns.append(_connected(a, valid, n_sq))
        ks.append(k_p)
    return torch.cat(ratios), torch.cat(conns), torch.cat(ks)


def _final(aff, rank, valid, n: int, kmax: int, KMAX: int, ratios, conns, ks) -> torch.Tensor:
    """The chosen p*, its spectral embedding, k-means and the separation
    check → labels [N] (pad rows' labels are meaningless)."""
    dev, N = aff.device, aff.shape[0]
    # prefer p whose graph is connected (the host's robustness rule); the
    # raw criterion when none is
    ps = torch.arange(1, ratios.shape[0] + 1, device=dev)
    p_ok = ps <= _p_cap(n)
    any_conn = (conns & p_ok).any()
    r_final = torch.where(any_conn, torch.where(p_ok & conns, ratios, math.inf),
                          torch.where(p_ok, ratios, math.inf))
    pi = torch.argmin(r_final)  # first min, like the host's strict '<'

    # the spectral embedding at p*. The speaker count: on the subspace path
    # from the accurate pass; on the eigvalsh path the sweep's own full
    # spectrum at p* decides it, as in the host oracle (eigh's eigenvalues
    # differ from eigvalsh's in the last bits, and an exact tie between two
    # gaps, as in the zero-norm fixture, would then depend on which ran)
    lap_star = _laplacian(_pruned(aff, rank, n, ps[pi]), valid)
    if _use_subspace(N, KMAX):
        lam_star, evecs = subspace_bottom(lap_star, min(max(_FINAL_SUB, KMAX + 2), N),
                                          _FINAL_ITERS)
        k_star = _eigengap(lam_star, kmax, KMAX)[0]
    else:
        evecs = torch.linalg.eigh(lap_star)[1]
        k_star = ks[pi]
    k = torch.clamp(k_star, 1, kmax)
    spec = evecs[:, :KMAX] * (torch.arange(KMAX, device=dev) < k)[None, :]
    rn = torch.sqrt((spec * spec).sum(1, keepdim=True))
    spec = torch.where(rn > 1e-9, spec / torch.clamp(rn, min=1e-9), spec)
    labels = _kmeans(spec, k, valid, KMAX)

    # separation check: one speaker when the clusters are not separated in
    # affinity space (host: the 0.9 factor)
    ii = torch.arange(N, device=dev)
    same = labels[:, None] == labels[None, :]
    triu = (ii[:, None] < ii[None, :]) & valid[:, None] & valid[None, :]
    w_sum = torch.where(same & triu, aff, 0.0).sum()
    b_sum = torch.where(~same & triu, aff, 0.0).sum()
    nw = (same & triu).sum().float()
    nb = (~same & triu).sum().float()
    sep_bad = ((nw > 0) & (nb > 0)
               & (b_sum / torch.clamp(nb, min=1.0) > 0.9 * (w_sum / torch.clamp(nw, min=1.0))))
    return torch.where(sep_bad | (k <= 1), 0, labels)


def nme_core(emb: torch.Tensor, n: int, kmax: int, KMAX: int, P: int) -> torch.Tensor:
    """NME-SC of the first n rows of bucket-padded embeddings [N, D] on their
    device → labels [N]: the graph, the sweep over p = 1..P, the final pass."""
    aff, rank, valid = _graph(emb, n)
    return _final(aff, rank, valid, n, kmax, KMAX, *_sweep(aff, rank, valid, n, kmax, KMAX, P))


def nme_sc_device(embeddings, max_speakers: int, device=None) -> np.ndarray:
    """NME-SC of [n, D] embeddings (an array, or a tensor) on ``device``
    (default: the card) → int64 labels [n]. A failure on the device raises."""
    dev = resolve_device(device)
    emb = torch.as_tensor(embeddings, dtype=torch.float32)
    n, d = emb.shape
    if n <= 2:
        return np.zeros(n, np.int64)
    kmax = max(1, min(max_speakers, n - 1))
    N = _bucket(n)
    KMAX = int(min(max(kmax, 1), N - 1))
    emb_pad = torch.zeros((N, d), dtype=torch.float32, device=dev)
    emb_pad[:n] = emb.to(dev)
    labels = nme_core(emb_pad, n, kmax, KMAX, _p_cap(N))
    return labels[:n].cpu().numpy().astype(np.int64)
