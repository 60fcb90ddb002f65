"""``program.issue_ms`` of the urban cells: ``spans.program_issue_ms``."""

from lbmbench import spans


def read(record, trace):
    return spans.program_issue_ms(record)
