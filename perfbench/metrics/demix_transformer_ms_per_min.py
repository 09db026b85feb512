"""The separator's cross-domain transformer: the CUDA-event time of the
port's ``demix.transformer`` spans (one a net and batch of chunks, inside
``demix.separate``; ``models/demucs_ref.py``), in ms of the device's stream
per minute of audio completed.  A port without the span gives nothing."""
from perfbench.metrics import _program_spans


def install(ctx):
    _program_spans.install(ctx)


def read(ctx):
    spans = [s for s in _program_spans.in_window(ctx) or () if s.name == "demix.transformer"]
    if not spans or ctx.audio_s <= 0:
        return None
    ctx.program_spans.resolve()
    ms = [s.device_ms for s in spans if s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / ctx.audio_min()
