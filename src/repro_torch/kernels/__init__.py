"""Kernels written by hand for Hopper, one per Pallas TPU kernel of the
JAX package. Each ships as a trio:

    <name>/kernel.py  — ctypes binding of csrc/<name>.cu (built at first use)
    <name>/ops.py     — public wrapper: kernel on CUDA, plain version on CPU
    <name>/ref.py     — plain PyTorch version, the oracle of the tests
"""
