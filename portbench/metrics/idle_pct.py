"""The share of the traced stretch of builds or query batches in which no
device operation ran (``idle_pct.<cell kind>``)."""
from portbench import trace


def read(reading):
    if not reading.trace.device:
        return None
    return trace.idle_pct(reading.trace)
