"""The flash attention forward kernel's share of its roofline over the
traced window, in per cent: the sum over its launches of the least time
each could take (``flops.flash_bound_s`` of the service that launched
it) over the sum of their device times."""
from servebench.flops import flash_bound_s


def read(run):
    t = run.trace
    if t is None:
        return None
    owner = t.owner(run.spans)
    bound = spent = 0.0
    for name, a, b in t.ops:
        if "flash_fwd" not in name:
            continue
        who = owner(a)
        if who is None:
            continue
        role = who.split("/")[0]
        cfg = run.cfg(role)
        if cfg["family"] == "ssm":
            continue
        B, S = run.shape(role)
        bound += flash_bound_s(cfg, B, S)
        spent += b - a
    return 100.0 * bound / spent if spent else None
