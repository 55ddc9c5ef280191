"""The plain reference of the benchmark: plain PyTorch and NumPy, float32
(float64 where the program's host path is float64), no hand-written
kernel, no cache, no batching tricks. It imports neither JAX nor anything of
the measured package, and takes nothing the program made: the harness hands
it the same inputs and weights it handed the program.

Its modules keep the state-dict names of the program's modules
(``trunk.stem.conv.kernel``, ``scale0.convs.0.kernel`` ...) and their
layout (HWIO kernels), so one dict of weights made by the harness loads into
both.
"""
