"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package each.

Each kernel package holds its CUDA source, ``ref.py`` (the plain PyTorch
version of the same function) and ``ops.py`` (the wrapper: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises).
``build.py`` compiles a source with ``nvcc`` at first use.
"""
