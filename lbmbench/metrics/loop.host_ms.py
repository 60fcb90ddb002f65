"""``loop.host_ms`` of the urban cells: ``spans.loop_host_ms``."""

from lbmbench import spans


def read(record, trace):
    return spans.loop_host_ms(record)
