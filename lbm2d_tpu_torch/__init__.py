"""lbm2d_tpu_torch: the D2Q9 MRT-LES lattice-Boltzmann dataset generator in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``lbm2d_tpu`` that keeps its layout (core/, ops/,
io/, utils/, viz/, pipeline/, native/) and imports nothing from it. The
serial case path runs end to end: ``pipeline.batch_run`` ->
``case_executor`` -> ``run_one_case`` -> ``core.engine.LBMEngine`` ->
``pipeline.sim_loop``. On a CUDA device each lattice step runs on the
kernels in ``csrc/`` (``ops/cuda_step.py``); on the CPU it runs the eager
reference step (``core/solver.py``). Entry points default to ``cuda``.
"""

__version__ = "0.1.0"
