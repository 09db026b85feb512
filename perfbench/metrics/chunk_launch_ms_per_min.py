"""Host ingest: the host wall of the port's ``ingest.launch`` spans (the
streamed path's loop that enqueues the eager chunk program once a 60 s
chunk), in ms per minute of audio completed."""
from perfbench.metrics import _program_spans


def install(ctx):
    _program_spans.install(ctx)


def read(ctx):
    spans = _program_spans.in_window(ctx)
    launch = [s for s in spans or () if s.name == "ingest.launch"]
    if not launch or ctx.audio_s <= 0:
        return None
    return sum(s.wall_ms for s in launch) / ctx.audio_min()
