"""Plain references the benchmark judges the program against.

Plain PyTorch and NumPy written from the published equations, in float64 by
default. Nothing here imports the program under test, JAX or the JAX
package, and nothing takes a table or a weight the program made: every
input comes from the configuration file, the seeded mask and, where a
comparison follows the program one chunk at a time, the program's own state
at the start of that chunk.
"""
