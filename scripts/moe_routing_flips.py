"""Where the served mixture of experts' logit gap comes from: routing flips
between the served bf16 model and the float32 reference.

    PYTHONPATH=src:. python3 scripts/moe_routing_flips.py --seed 3100001001

For the low model of a cell (by default M.moe_fill's Qwen3-30B-A3B, at full
width, with the benchmark's weights of ``--seed``) and the low prompts a
run of that seed checks, it prints one JSON line per prompt:

- ``flipped_share``: per layer, the share of tokens whose set of top-k
  experts differs between the served forward (eager segments, the path a
  replay equals bit for bit) and the reference;
- ``gap``: the logit gap as the benchmark's comparison computes it, and
  ``control_gap``, the same for the reference in float8 (``control.py``);
- ``gap_at_served_routing`` and ``control_gap_at_served_routing``: both
  again with the reference routed as the served model routed (each token
  sent to the served model's experts, its gates the reference's own
  probabilities of them, renormalised): routing flips taken out, the
  arithmetic left.

Needs the card for a full-width model; a cell's name and ``--layers``
(a depth cut) let it run smaller.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="M.moe_fill")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0,
                    help="the run's window, which sets the checked prompts")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the low model to this many layers (0: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.models import api, moe
    from repro_torch.models.segmentation import SegmentedService
    from servebench import harness, traffic, weights as wt
    from servebench.catalog import load_reference
    from servebench.compare import logit_gap
    from servebench.reference.arith import Arith

    dev = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    model_cfg = cell.config["low"]
    over = {"num_layers": args.layers} if args.layers else {}
    cfg = harness.port_config(model_cfg, **over)
    cfg_d = dataclasses.asdict(cfg)
    ref = load_reference(model_cfg["reference"])
    params = wt.make(ref.param_specs(cfg_d), wt.generator(args.seed, "low",
                                                          dev),
                     getattr(torch, cfg.dtype), dev)
    model = api.build_params(cfg, 0, "meta")
    wt.load_into(model, params)
    mix = cell.mix
    B, S = mix["low"]["batch"], mix["low"]["seq"]
    svc = SegmentedService(cfg, model, B, S)
    n_high = len(traffic.open_loop(mix["high"]["arrivals"], args.seconds,
                                   args.seed))
    rids = traffic.sampled(mix, args.seed, n_high)["low_prompts"]
    prompts = traffic.prompts(args.seed, "low", traffic.LOW_PROMPTS, B, S,
                              cfg.vocab_size, dev)

    served_idx, ref_idx = [], []
    program_route, reference_route = moe._route, ref.route

    def recording_route(x2, p, c):
        out = program_route(x2, p, c)
        served_idx.append(out[2])
        return out
    moe._route = recording_route

    def reference_recording(h2, router, k, arith):
        gates, experts = reference_route(h2, router, k, arith)
        ref_idx.append(experts)
        return gates, experts

    def at_served_routing(layers):
        it = iter(layers)

        def route(h2, router, k, arith):
            probs = torch.softmax(arith.mm(h2, router), dim=-1)
            experts = next(it).to(probs.device)
            g = probs.gather(1, experts)
            return g / g.sum(dim=-1, keepdim=True), experts
        return route

    def w(name):
        return params[name].float()

    for rid in rids:
        tokens = prompts[rid]
        served_idx.clear()
        ref_idx.clear()
        with torch.inference_mode():
            state = tokens
            for seg in svc.segments:
                state = seg.fn.eager(state)
            prog = state.float()
        with torch.no_grad():
            ref.route = reference_recording
            exact = ref.logits(w, tokens, cfg_d, Arith())
            rec = {"prompt": rid, "gap": logit_gap(prog, exact)}
            rec["flipped_share"] = [
                round(float((torch.sort(a, -1)[0] != torch.sort(b, -1)[0])
                            .any(-1).float().mean()), 5)
                for a, b in zip(served_idx, ref_idx)]
            ref.route = reference_route
            control = ref.logits(w, tokens, cfg_d, Arith(fp8=True))
            rec["control_gap"] = logit_gap(control, exact)
            del control, exact
            ref.route = at_served_routing(list(served_idx))
            exact = ref.logits(w, tokens, cfg_d, Arith())
            rec["gap_at_served_routing"] = logit_gap(prog, exact)
            ref.route = at_served_routing(list(served_idx))
            control = ref.logits(w, tokens, cfg_d, Arith(fp8=True))
            rec["control_gap_at_served_routing"] = logit_gap(control, exact)
            ref.route = reference_route
            del control, exact
        share = rec["flipped_share"]
        rec["flipped_share_mean"] = sum(share) / len(share)
        print(json.dumps(rec), flush=True)
    moe._route = program_route
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
