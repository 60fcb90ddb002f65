"""``lattice_roofline.dfg`` of dfg.re100: ``readers.lattice_share``."""

from lbmbench import readers


def read(record, trace):
    return readers.lattice_share(record, trace, "dfg")
