"""``loop.fetch_stall`` of urban5.prod: ``readers.fetch_stall``."""

from lbmbench import readers


def read(record, trace):
    return readers.fetch_stall(record)
