"""The unit's operations, as the reference counts them (a training
step's forward and backward without any recompute; a volume's patch
forwards; the real slices of a case), times the units of the traced
run's stretch timed without the profiler, over that stretch's wall time
and the H100's float32 peak, in %."""

from portbench.counts import F32_FLOP_PER_S


def read(ctx):
    return 100.0 * ctx.counts["flops"] * ctx.plain["work"] / ctx.plain["window_s"] / F32_FLOP_PER_S
