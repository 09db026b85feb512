"""Device waits: the host wall of every span of the port in which the host
blocks on the card (``stage_timer(..., wait=True)``: the packed copy's
``collect.wait``, the whole-file path's ``dispatch.copy``, and the other
waits PERF.md lists), in ms per minute of audio completed."""
from perfbench.metrics import _program_spans


def install(ctx):
    _program_spans.install(ctx)


def read(ctx):
    spans = _program_spans.in_window(ctx)
    if not spans or ctx.audio_s <= 0:
        return None
    waits = _program_spans.outer_waits(ctx, spans)
    return sum(s.wall_ms for s in waits) / ctx.audio_min()
