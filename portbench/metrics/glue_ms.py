"""Device milliseconds a build spends outside the port's hand-written
kernels: the torch operations, copies and sets of the construction and
index modules, from the traced stretch (``glue_ms.<cell kind>``)."""
from portbench import trace


def read(reading):
    if not reading.trace.device:
        return None
    return trace.glue_us(reading.trace) / 1e3 / reading.units
