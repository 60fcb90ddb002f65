"""``serial.host_us`` of dfg.re100: ``spans.serial_host_us``."""

from lbmbench import spans


def read(record, trace):
    return spans.serial_host_us(record)
