"""Device ms per step of the `multi_tensor_apply` kernels: the
gradient clip's norms and scaling and the foreach SGD."""


def read(ctx):
    s = ctx.profile.class_s("optimizer")
    return 1e3 * s / ctx.units if s else None
