"""Device operations (kernels, copies, sets) a build or a query batch
launches, its readback included, from the traced stretch
(``launches.<cell kind>``)."""


def read(reading):
    if not reading.trace.device:
        return None
    return len(reading.trace.device) / reading.units
