"""PyTorch/CUDA port of the FIKIT reproduction.

The JAX package ``repro`` is the reference; this package does the same
work on an NVIDIA GPU and imports nothing of it (nor of JAX). Its entry
points take an explicit ``device`` and default to ``"cuda"``; the CPU is
used only when the caller asks for it, as the tests do.
"""
