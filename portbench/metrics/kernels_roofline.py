"""The cell's hand-written kernels together: the sum of their work's
bounds over the sum of their device times in the traced stretch
(``kernels_roofline.<cell kind>``)."""
from portbench import trace, work


def read(reading):
    return trace.roofline_pct(reading.bound_ms, reading.trace,
                              work.KERNEL_SYMBOLS)
