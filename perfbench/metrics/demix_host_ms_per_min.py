"""The demix-dialog front-end's host resampling: the host wall of the
port's ``demix.resample-in`` and ``demix.resample-out`` spans (scipy's
polyphase resampling from 16 kHz to 44.1 kHz stereo and back,
``pipelines/enhance.py``), in ms per minute of audio completed.  The
copies either way are waits that hold whatever the card had queued before
them; ``copy_wait_ms_per_min`` reads those.  A port without the spans gives
nothing."""
from perfbench.metrics import _program_spans

STAGES = ("demix.resample-in", "demix.resample-out")


def install(ctx):
    _program_spans.install(ctx)


def read(ctx):
    spans = [s for s in _program_spans.in_window(ctx) or () if s.name in STAGES]
    if not spans or ctx.audio_s <= 0:
        return None
    return sum(s.wall_ms for s in spans) / ctx.audio_min()
