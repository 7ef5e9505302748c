"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
Python wrappers, and their plain PyTorch versions (``ref``).

Nothing here compiles or imports a GPU toolchain at import time.
"""
