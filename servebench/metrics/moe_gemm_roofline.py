"""The grouped expert product's share of its roofline over the low
service's launches in the traced window, in per cent: the sum over its
two kernels' launches (gate and up, then down) of the least time each
could take (``moe_flops``, from the low model's shapes) over the sum of
their device times. None where no such kernel ran (a program without the
grouped product)."""
from servebench import moe_flops

#: the kernels' names, each with the bound of one of its launches
KERNELS = {"moe_grouped_gate_up": moe_flops.gate_up_bound_s,
           "moe_grouped_down": moe_flops.down_bound_s}


def read(run):
    t = run.trace
    if t is None:
        return None
    owner = t.owner(run.spans)
    cfg = run.cfg("low")
    B, S = run.shape("low")
    bound = spent = 0.0
    for name, a, b in t.ops:
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        who = owner(a)
        if who is None or not who.startswith("low/"):
            continue
        bound += KERNELS[kernel](cfg, B, S)
        spent += b - a
    return 100.0 * bound / spent if spent else None
