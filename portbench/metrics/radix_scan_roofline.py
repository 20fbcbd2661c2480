"""``radix_scan``'s share of its roofline: its work's bound over its device
time in the traced stretch."""
from portbench import trace


def read(reading):
    return trace.roofline_pct(reading.bound_ms, reading.trace,
                              ("radix_scan",))
