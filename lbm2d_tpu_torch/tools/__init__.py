"""Tools of the port: the mask and case-config generators and file tools
(copies of the JAX package's ``tools/``), the command-line tools that
measure it on a GPU (the trace and roofline tools), the cases they share
(the smoke case, the square demo case), and the obstacle shapes."""
