"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the switch the engine calls; ``ref`` holds the plain versions;
``build`` compiles ``csrc/*.cu`` with nvcc and binds them with ctypes.
"""
