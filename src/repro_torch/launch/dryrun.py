"""Multi-pod dry-run (``repro.launch.dryrun``): run every (architecture x
input shape) step on the production meshes with nothing allocated, and
dump the roofline inputs (FLOPs, bytes, per-collective traffic) and the
per-device memory of its arguments and outputs as JSON.

The JAX package lowers and compiles each step for 256 (or 512) simulated
devices. The port runs the step itself, eagerly, on the ``meta`` device:
the mesh is ``make_production_mesh()`` over PyTorch's ``"fake"`` backend
(its collectives move nothing), the parameters, optimizer state, batch
and caches are ``DTensor``s with meta shards placed by the specs, and
``launch.cost.CostMode`` counts the per-device program. The kernel
wrappers route meta tensors to their plain versions' shapes, as they
route CPU tensors.

- ``mem.argument_bytes`` / ``output_bytes``: exact, the local shards'
  bytes of the step's arguments and results (a host position counted as
  the int32 scalar the JAX program takes).
- ``mem.temp_bytes``: the step's peak past its arguments, from
  ``torch.distributed._tools.mem_tracker.MemTracker`` over a second run
  (it tracks meta tensors), else null with the reason in
  ``mem.temp_note``; ``peak_bytes`` adds arguments, outputs and temps, as
  the JAX package's record does.
- ``flops``, ``bytes_accessed``, ``collective_bytes``: ``CostMode``'s
  counts (unfused bytes: an upper bound on a fused program's).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.config import SHAPES, get_config
from repro_torch.configs import ARCH_IDS

# (arch, shape) combos excluded from long_500k: pure full-attention archs
# (quadratic decode state), as in the JAX package.
LONG_SKIP = {
    "stablelm-1.6b": "full attention, no sub-quadratic variant",
    "granite-20b": "full attention, no sub-quadratic variant",
    "qwen3-4b": "full attention, no sub-quadratic variant",
    "deepseek-v2-236b": "full MLA attention, no sub-quadratic variant",
    "seamless-m4t-medium": "enc-dec with full decoder attention",
}


def combos():
    for arch in ARCH_IDS:
        for sname in SHAPES:
            if sname == "long_500k" and arch in LONG_SKIP:
                continue
            yield arch, sname


def _placed_args(cfg, fn, args, mesh, kind):
    """The step's example arguments made ``DTensor``s by its specs (the
    parameters in place), as the step itself would place them."""
    from repro_torch.launch.steps import _place_model
    from repro_torch.sharding import specs as sh
    sp = fn.specs
    model = args[0]
    _place_model(model, mesh, sp["params"])
    if kind == "train":
        model.requires_grad_(True)
        _, opt, batch, labels = args
        return (model, sh.shard_opt_state(opt, mesh, sp["opt"]),
                sh.place(batch, mesh, sp["batch"]),
                sh.place(labels, mesh, sp["labels"]))
    if kind == "prefill":
        return model, sh.place(args[1], mesh, sp["batch"])
    _, tok, pos, caches = args
    return (model, sh.place(tok, mesh, sp["token"]), pos,
            sh.place(caches, mesh, sp["caches"]))


def _temp_bytes(cfg, mesh, shape, arg_bytes: int):
    """(bytes, note): the step's peak memory past its arguments, from
    ``MemTracker`` (the arguments registered, so its peak counts them),
    over a second run of the step on fresh arguments; None and the
    reason where it fails."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch.steps import make_step
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        fn, args = make_step(cfg, mesh, shape)
        placed = _placed_args(cfg, fn, args, mesh, shape.kind)
        mt = MemTracker()
        mt.track_external(placed[0], *(
            t for t in tree_leaves(placed[1:]) if hasattr(t, "shape")))
        with mt:
            fn(*placed)
        peak = mt.get_tracker_snapshot("peak")
        total = sum(dev.get("Total", 0) for dev in peak.values())
        return max(int(total) - arg_bytes, 0), "MemTracker peak - arguments"
    except Exception as e:  # noqa: BLE001 - the reason is the record
        return None, f"MemTracker: {type(e).__name__}: {e}"


def run_one(arch: str, sname: str, multi_pod: bool = False,
            verbose: bool = True, shape=None) -> dict:
    """One record; ``shape`` (an ``InputShape``) runs in place of
    ``SHAPES[sname]``."""
    from repro_torch.launch.cost import CostMode, local_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_step

    cfg = get_config(arch)
    shape = shape or SHAPES[sname]
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    fn, args = make_step(cfg, mesh, shape)
    placed = _placed_args(cfg, fn, args, mesh, shape.kind)
    t_build = time.time() - t0
    arg_bytes = local_bytes(placed)
    with CostMode() as cm:
        out = fn(*placed)
    t_run = time.time() - t0 - t_build
    out_bytes = local_bytes(out[:2] if shape.kind == "train" else out)
    if shape.kind == "train":
        out_bytes += local_bytes(out[2])
    temp, note = _temp_bytes(cfg, mesh, shape, arg_bytes)
    rec = {
        "arch": arch,
        "shape": sname,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": mesh.size(),
        "build_s": round(t_build, 1),
        "run_s": round(t_run, 1),
        **cm.record(),
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_bytes": None if temp is None
            else arg_bytes + out_bytes + temp,
            "temp_note": note,
        },
    }
    if verbose:
        print(f"[dryrun] {arch} x {sname} on {rec['mesh']}: "
              f"build {t_build:.1f}s run {t_run:.1f}s")
        print(f"  memory: args={arg_bytes / 2**30:.2f}GiB "
              f"out={out_bytes / 2**30:.2f}GiB temp={temp}")
        print(f"  cost: flops={rec['flops']:.3e} "
              f"bytes={rec['bytes_accessed']:.3e}")
        coll = {k: round(v / 2**30, 2)
                for k, v in rec["collective_bytes"].items()}
        print(f"  collectives: {coll} GiB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on the single-pod mesh")
    ap.add_argument("--all-multipod", action="store_true",
                    help="run every (arch x shape) on the 2x16x16 mesh")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    records = []
    if args.all or args.all_multipod:
        todo = [(a, s, args.all_multipod) for a, s in combos()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        if args.shape == "long_500k" and args.arch in LONG_SKIP:
            print(f"[dryrun] SKIP {args.arch} x long_500k: "
                  f"{LONG_SKIP[args.arch]}")
            return 0
        todo = [(args.arch, args.shape, args.multi_pod)]

    def save(recs):
        if not args.out or not recs:
            return
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        keyed = {(r["arch"], r["shape"], r["mesh"]): r for r in existing}
        for r in recs:
            keyed[(r["arch"], r["shape"], r["mesh"])] = r
        with open(args.out, "w") as f:
            json.dump(list(keyed.values()), f, indent=1)

    from repro_torch.launch.mesh import destroy_host_group
    failures = []
    try:
        for arch, sname, mp in todo:
            try:
                rec = run_one(arch, sname, multi_pod=mp)
                records.append(rec)
                save([rec])         # incremental: survive interruption
            except Exception as e:  # noqa: BLE001
                failures.append((arch, sname, repr(e)))
                print(f"[dryrun] FAIL {arch} x {sname}: {e}")
    finally:
        destroy_host_group()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        return 1
    print(f"[dryrun] OK ({len(records)} combos)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
