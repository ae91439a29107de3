"""The encoder's time a batch: CUDA events around each call of ``encode``
(the benchmark's span on the name the package calls), their mean."""


def read(r):
    ms = r.span_device_ms.get("encode") or []
    return sum(ms) / len(ms) if ms else None
