"""Device ms in cuDNN's NCHW <-> NHWC conversion kernels per image."""


def read(ctx):
    if not ctx.trace.device or not ctx.n_images:
        return None
    return 1e3 * ctx.trace.by_class().get("layout", (0.0, 0))[0] / ctx.n_images
