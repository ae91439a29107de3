"""The readings that a cell's check limits are set from.

    python3 -m portbench.control --workload NAME --seeds 11,12,... \
        --seconds S [--control 3] [--out chiprun_out/limits.jsonl]

Runs the cell once a seed in this one process (set-up, a window of
``--seconds`` at the cell's own load, the check) and prints one JSON line a
seed with every number compared; for the first ``--control`` seeds also
the control's reading of the same numbers (the plain reference computed in
TensorFloat-32, put in the program's place) and further readings. The
lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .cells import ROOT, load_cell
from .run import cache_dirs, forbidden_modules, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    a = p.parse_args(argv)
    cache_dirs()
    os.chdir(ROOT)
    cell = load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench.control: {a.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    for n, seed in enumerate(seeds):
        out = run(cell, seed, a.seconds, False, "cuda", control=n < a.control)
        line = json.dumps({"workload": a.workload, "seed": seed, "metrics": out["metrics"],
                           "attempted": out["attempted"], "check": out["check"],
                           "device": out["device"]})
        print(line, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"portbench.control: the JAX side was imported: {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
