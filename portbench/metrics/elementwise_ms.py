"""Device ms per unit of every kernel that is no hand kernel, no
convolution or GEMM and no optimizer kernel: norms, softmax, activations,
copies, fills, the blend and the argmax."""


def read(ctx):
    s = ctx.profile.class_s("elementwise")
    return 1e3 * s / ctx.units if s else None
