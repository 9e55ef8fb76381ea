"""End-to-end training with the PyTorch/CUDA port: a few hundred steps of
a reduced model through the same ``train_step`` that trains the published
widths on the card (AdamW, the synthetic pipeline, a checkpoint in the
JAX package's msgpack layout, which needs ``msgpack``).

    PYTHONPATH=src python examples/torch_train_tiny.py --device cpu \\
        [--steps 200]
    PYTHONPATH=src python examples/torch_train_tiny.py --arch qwen3-4b \\
        --full --steps 4 --batch 2 --seq 2048 --ckpt ''

(``--ckpt ''`` where ``msgpack`` is not installed.) The default arch is
the JAX package's example's, the MoE llama4-scout-17b-a16e (reduced: 4
experts, top-1 + a shared expert, chunked and full attention). At full
width its 109 B parameters do not fit one card; training it there waits
for the sharding slice, so ``--full`` takes another arch, e.g. qwen3-4b.
"""
import argparse
import os

from repro_torch.launch.train import train

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama4-scout-17b-a16e")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "torch_tiny_ckpt.msgpack"),
        help="checkpoint path; '' for none (writing one needs msgpack)")
    args = ap.parse_args()
    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, reduced=not args.full, device=args.device,
                   ckpt_path=args.ckpt)
    n = min(10, len(losses))
    first = sum(losses[:n]) / n
    last = sum(losses[-n:]) / n
    print(f"mean loss first-{n}={first:.4f} last-{n}={last:.4f} "
          f"({'improved' if last < first else 'no improvement'})")
