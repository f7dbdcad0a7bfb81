"""Seconds in ``Solver((n, src, dst, w))`` alone: the host layout build
and the move to the device (host clock, ending in a synchronize)."""


def read(record):
    return record.layout_build_s
