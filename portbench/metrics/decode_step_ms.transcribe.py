"""Wall time a decode step: the spans around ``sample_decode`` (the card
synchronised at their end), each from the moment its work could start on
the card (the later of the span's start and the end of the device work
launched before it, the encoder's), summed over the cached steps they ran."""


def read(r):
    walls = r.span_walls("decode loop")
    steps = r.units.get("decode_steps", 0)
    if not walls or not steps:
        return None
    return sum(walls) / 1e6 / steps
