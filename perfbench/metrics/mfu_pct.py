"""The whole step's share of the chip's peak: the operations every network
and both kernels need for the audio completed in the window (counted over
the frozen reference, ``harness/flops.py``), over the traced window times
the H100's dense bfloat16 peak, in %."""
from perfbench.reference.ops import cost


def read(ctx):
    if not ctx.files or ctx.window_s <= 0:
        return None
    flops = sum(ctx.flops_of_file(f) for f in ctx.files)
    return 100.0 * flops / (ctx.window_s * cost.PEAK_FLOPS["bf16_tensor"])
