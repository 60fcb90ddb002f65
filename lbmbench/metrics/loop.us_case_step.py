"""``loop.us_case_step`` of the urban cells: ``readers.us_case_step``."""

from lbmbench import readers


def read(record, trace):
    return readers.us_case_step(record)
