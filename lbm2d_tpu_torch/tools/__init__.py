"""Tools of the port: the command-line tools that measure it on a GPU, the
smoke case they share, and the analytic obstacle outlines."""
