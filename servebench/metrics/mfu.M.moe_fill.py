"""Model operations of every forward of both services completed in the
window, over the window's seconds at the H100's bf16 peak, in per cent:
the dense high model by ``flops.forward_flops``, the low mixture of
experts by its routed work (``moe_flops.forward_flops``: T * k entries
through the experts, attention, router and head)."""
from servebench import flops, moe_flops


def read(run):
    ops = 0
    for role in ("high", "low"):
        cfg = run.cfg(role)
        count = (moe_flops if cfg["family"] == "moe" else flops).forward_flops
        B, S = run.shape(role)
        ops += count(cfg, B, S) * len(run.completed_in_window(role))
    return 100.0 * ops / (run.seconds * flops.PEAK_BF16_FLOPS) if ops \
        else None
