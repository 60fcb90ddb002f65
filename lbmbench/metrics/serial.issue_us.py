"""``serial.issue_us`` of dfg.re100: ``spans.serial_issue_us``."""

from lbmbench import spans


def read(record, trace):
    return spans.serial_issue_us(record)
