"""``loop.write_ms`` of urban5.prod: ``spans.loop_write_ms``."""

from lbmbench import spans


def read(record, trace):
    return spans.loop_write_ms(record)
