"""Host ingest: the host wall of ``DiarizationPipeline.stream_start``
(quantize, pinned upload, SNR probe, the per-chunk launches), in ms per
minute of audio completed.  A wrapper on the pipeline instance times it, so
the corpus route, which calls ``stream_start`` directly, is timed too."""


def install(ctx):
    ctx.wrap(ctx.pipe, "stream_start", ctx.host_span("ingest"))


def read(ctx):
    ms = ctx.span_ms("ingest")
    if ms is None or ctx.audio_s <= 0:
        return None
    return ms / ctx.audio_min()
