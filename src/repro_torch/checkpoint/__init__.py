from repro_torch.checkpoint.ckpt import (  # noqa: F401
    load_checkpoint, save_checkpoint)
