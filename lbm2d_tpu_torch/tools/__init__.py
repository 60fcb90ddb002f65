"""Tools of the port: the command-line tools that measure it on a GPU (the
trace and roofline tools), the cases they share (the smoke case, the square
demo case), and the analytic obstacle outlines."""
