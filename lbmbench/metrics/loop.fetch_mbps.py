"""``loop.fetch_mbps`` of urban5.prod: ``spans.loop_fetch_mbps``."""

from lbmbench import spans


def read(record, trace):
    return spans.loop_fetch_mbps(record)
