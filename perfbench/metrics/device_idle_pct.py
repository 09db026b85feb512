"""The device's idle share of the traced window: the time in which no
kernel, copy or fill ran, from ``torch.profiler``, in %."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
