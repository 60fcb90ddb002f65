"""``lattice_roofline.dataset`` of the urban cells: ``readers.lattice_share``."""

from lbmbench import readers


def read(record, trace):
    return readers.lattice_share(record, trace, "dataset")
