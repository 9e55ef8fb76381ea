"""Training driver (``repro.launch.train``): real training through the
step builder's ``train_step``, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --full
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --device cpu --steps 50 --batch 8 --seq 128

Without ``--full`` the config runs at ``.reduced()`` scale, as in the JAX
package. ``train(..., mesh=...)`` trains under a mesh that shards (more
than one device). With no mesh, or one of a single device such as the
JAX package's (1, 1) host mesh, the un-meshed step runs: on one device
it gives the meshed step's bits (``chip_smoke.py`` phase 11 holds them
so) without DTensor's eager dispatch, which made the full-depth qwen3-4b
step 1.5-1.8x slower on an H100. ``--ckpt`` writes ``{"params": state
dict, "opt": AdamW state}`` in the JAX package's msgpack layout and
needs ``msgpack``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import ENCDEC, VLM, InputShape, get_config
from repro_torch.data.pipeline import SyntheticTextPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype
from repro_torch.models.vlm import stub_patches
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.specs import unshard, unshard_model


def train_inputs(cfg, tokens, labels, batch: int, seq: int, device):
    """The model's batch and labels from the pipeline's [batch, seq]
    tokens and labels: the VLM's stub patches before seq - P tokens
    (labels -100 over the patches), the encoder-decoder's zero frames
    before the tokens, the tokens alone otherwise."""
    tokens = torch.from_numpy(tokens).to(device)
    labels = torch.from_numpy(labels).to(device)
    if cfg.family == VLM:
        P = cfg.num_patches
        batch_in = (stub_patches(cfg, batch, device=device),
                    tokens[:, :seq - P])
        labels = torch.cat([torch.full((batch, P), -100, dtype=torch.int32,
                                       device=device), labels[:, :seq - P]],
                           dim=1)
        return batch_in, labels
    if cfg.family == ENCDEC:
        frames = torch.zeros((batch, cfg.encoder_frames, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device=device)
        return (frames, tokens), labels
    return tokens, labels


def train(arch: str, steps: int = 20, batch: int = 8, seq: int = 128,
          reduced: bool = True, seed: int = 0, log_every: int = 5,
          ckpt_path: str = "", device="cuda", model=None, on_step=None,
          mesh=None):
    """Train ``arch`` for ``steps`` steps of the synthetic pipeline's
    batches; returns the losses, as the JAX package's driver does.

    Two options the JAX package's driver lacks, for a caller that checks
    the run (``chip_smoke.py``'s train phase): ``model`` trains weights
    the caller built and keeps (else they come from ``seed``), so it can
    compare them before and after; ``on_step(step, metrics)`` is called
    after each step with its metrics, so it can time the steps and read
    each step's ``grad_norm`` and ``lr``. Under a ``mesh`` of more than
    one device the parameters are ``DTensor``s while the steps run;
    ``model`` comes back with plain ones."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if mesh is not None and mesh.size() == 1:
        mesh = None
    shape = InputShape("cli", seq, batch, "train")
    step_fn, _ = make_train_step(cfg, mesh, shape, grad_accum=1)

    if model is None:
        model = api.build_params(cfg, seed, device)
    model.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    pipe = SyntheticTextPipeline(cfg.vocab_size, batch, seq,
                                 seed=seed).start()
    losses = []
    t0 = time.time()
    try:
        for step in range(steps):
            tb = next(pipe)
            batch_in, labels = train_inputs(cfg, tb.tokens, tb.labels, batch,
                                            seq, device)
            model, opt, metrics = step_fn(model, opt, batch_in, labels)
            loss = float(metrics["loss"])
            losses.append(loss)
            if on_step is not None:
                on_step(step, metrics)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:4d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0):.1f}s)")
    finally:
        pipe.stop()
        unshard_model(model)
    opt = unshard(opt)
    if ckpt_path:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(ckpt_path, {"params": model.state_dict(),
                                    "opt": opt}, step=steps)
        print(f"saved checkpoint to {ckpt_path}")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the .reduced() config (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depths instead of the "
                         ".reduced() config")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args()
    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, reduced=not args.full,
                   ckpt_path=args.ckpt, device=args.device)
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")


if __name__ == "__main__":
    main()
