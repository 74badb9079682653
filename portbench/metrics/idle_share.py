"""The share of the traced stretch in which no operation ran on the
device, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.window_s)
