"""Mint a working RNNoise model on synthetic mixtures, on the card.

    python -m crispy_tpu_torch.tools.train_rnnoise --steps 2000 --corpus-streams 256

The port of ``tools/train_rnnoise.py``: the same flags and defaults, plus
``--device`` (default the card; ``cpu`` runs the plain PyTorch path). The
result is int8-quantized into the reference's weight grid, checked by its
SNR improvement on a held-out mixture and saved, by default over the port's
packaged ``builtin_weights.npz``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

PACKAGED = Path(__file__).resolve().parents[1] / "dsp" / "rnnoise" / "builtin_weights.npz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m crispy_tpu_torch.tools.train_rnnoise",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-streams", type=int, default=32)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=Path, default=PACKAGED)
    ap.add_argument("--corpus-streams", type=int, default=None,
                    help="device-resident training from a fixed int16 pool")
    ap.add_argument("--steps-per-call", type=int, default=25)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from ..dsp.rnnoise import training

    t0 = time.perf_counter()
    model, losses = training.train_model(
        steps=args.steps, batch_streams=args.batch_streams,
        frames=args.frames, learning_rate=args.lr, log_every=max(args.steps // 20, 1),
        corpus_streams=args.corpus_streams, steps_per_call=args.steps_per_call,
        device=args.device,
    )
    print(f"trained in {time.perf_counter() - t0:.0f}s; loss curve: "
          f"{[round(v, 4) for v in losses]}")
    gain = training.snr_improvement(model, device=args.device)
    print(f"held-out SNR improvement: {gain:+.2f} dB")
    model.save(args.out)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
