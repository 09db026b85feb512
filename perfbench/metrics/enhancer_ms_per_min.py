"""The whole-file path's enhancer (``pipelines/enhance.py``, GTCRN): CUDA
events around the pipeline's ``enhance_fn``, in ms of the device's stream
per minute of audio completed."""


def install(ctx):
    if getattr(ctx.pipe, "enhance_fn", None) is not None:
        ctx.wrap(ctx.pipe, "enhance_fn", ctx.cuda_span("enhancer"))


def read(ctx):
    ms = ctx.span_ms("enhancer")
    if ms is None or ctx.audio_s <= 0:
        return None
    return ms / ctx.audio_min()
