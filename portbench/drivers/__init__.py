"""Drivers: one per kind of work the port does, named by a traffic file's
``driver``. A driver module has ``Driver(cell, seed, device)`` with:

- ``rate_metric``: the end-to-end rate it reports (work over the window);
- ``call_name``: the span name of one timed call;
- ``setup()``: the program's objects, the inputs from the seed, and a
  warm-up of every shape the window uses;
- ``call(i) -> work``: timed call i (work in the rate's numerator);
- ``items_per_call``: requests in one call (recordings, chunks);
- ``units(calls) -> dict``, ``flops_done(calls)``, ``kernel_bounds()``: what
  the per-layer readers divide by;
- ``instrument(spans)``: the traced run's spans around program functions;
- ``span_device_ms``: CUDA-event times of spans, by name (traced run);
- ``release()``: drops the program's state before the check;
- ``check(calls, control=False) -> dict``: each number compared, as
  ``{"value", "limit"}``, and with ``control`` the control's readings of
  the same numbers under ``"control."`` names.
"""
