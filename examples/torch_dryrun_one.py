"""Run ONE (arch x shape) step of the PyTorch port on the production mesh
with nothing allocated (meta tensors over the fake backend) and print its
per-device memory, cost and collective traffic.

    PYTHONPATH=src python examples/torch_dryrun_one.py --arch mamba2-2.7b \
        --shape decode_32k [--multi-pod] [--out results.json]
"""
import sys

from repro_torch.launch import dryrun

if __name__ == "__main__":
    sys.exit(dryrun.main())
