"""Bits of every tensor the build leaves resident (each storage once), a
token, counted by the benchmark from the returned structure."""


def read(reading):
    return reading.bits_per_token
