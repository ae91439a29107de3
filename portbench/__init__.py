"""The benchmark of the PyTorch and CUDA port (``crispy_tpu_torch``).

``python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card (``run.py``). Cells are
data: ``configs/`` (a configuration and its plain reference's inputs),
``traffic/`` (a mix and the driver in ``drivers/`` that runs it),
``metrics/`` (one reader a per-layer metric). ``reference/`` holds the
plain references, ``counts.py`` and ``peaks.json`` the yardstick's
arithmetic, ``control.py`` the readings of the limits, ``tests/`` the CPU
tests (``python -m pytest portbench/tests``).
"""
