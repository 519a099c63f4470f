"""K2's share of its roofline, in percent: the least time of one batched
launch, max(FP32 operations / peak, bytes / peak bandwidth) from the pairs
the benchmark counts itself (every site pair within the cutoff, as K2
evaluates them, each once with its reaction), over K2's device time per
launch in the profiled window (its force kernel and its energy sum).
None where K2 did not run."""
from benchmark import counts as c

K2_KERNELS = ("direct_force_kernel", "direct_force_energy")


def read(ctx):
    launches = sum(1 for name, _, _ in ctx.events
                   if K2_KERNELS[0] in name)
    if not launches:
        return None
    us = sum(e - s for name, s, e in ctx.events
             if any(k in name for k in K2_KERNELS))
    ms = us * 1e-3 / launches
    bound = c.roofline_ms(ctx.replicas * c.direct_ops(ctx.pairs),
                          ctx.replicas * c.direct_bytes(ctx.sites))
    return 100.0 * bound / ms
