"""End-to-end serving with the PyTorch/CUDA port: two real models (qwen3
high priority + mamba2 low) share the device through the wall-clock FIKIT
engine, with their segments run by the port's kernels on the card.

Lifecycle per the paper: onboard (measurement phase, exclusive, per-kernel
timing) -> concurrent sharing phase under FIKIT vs default sharing; then
the same workload over TWO device executors through the placement layer,
and the sjf and edf queue disciplines (see examples/serve_priority.py,
the JAX package's version).

    PYTHONPATH=src python examples/torch_serve_priority.py --device cpu
    PYTHONPATH=src python examples/torch_serve_priority.py --full

At reduced size the sequence is 64: reduced mamba2's 32-token SSD chunk
must divide it (48 trips its assertion, in both packages). At the
published widths the chunk is 256, so seq 48 is one chunk.
"""
import argparse

from repro_torch.launch.serve import serve_pair

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depths")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kw = dict(requests=6, measure_runs=4, seq=48 if args.full else 64,
              reduced=not args.full, device=args.device)
    for mode in ("sharing", "fikit"):
        print(f"--- mode={mode} ---")
        serve_pair("qwen3-4b", "mamba2-2.7b", mode=mode, **kw)
        print()

    print("--- mode=fikit devices=2 (placement layer) ---")
    serve_pair("qwen3-4b", "mamba2-2.7b", mode="fikit", devices=2, **kw)
    print()

    # Intra-device queue disciplines (repro_torch.core.queues.
    # QUEUE_DISCIPLINES): "sjf" orders each priority level
    # shortest-predicted-first; "edf" by the per-request deadline tag --
    # here every low-priority invocation carries a 250 ms budget, and
    # deadline_misses counts blown budgets.
    print("--- mode=fikit discipline=sjf ---")
    serve_pair("qwen3-4b", "mamba2-2.7b", mode="fikit", discipline="sjf",
               **kw)
    print()

    print("--- mode=fikit discipline=edf deadline=0.25 ---")
    serve_pair("qwen3-4b", "mamba2-2.7b", mode="fikit", discipline="edf",
               deadline=0.25, **kw)
    print()
