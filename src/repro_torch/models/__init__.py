"""Model zoo: PyTorch modules of the dense decoder family."""
