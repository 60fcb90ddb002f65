"""Physics validation of the port (DFG-2D cylinder benchmark)."""
