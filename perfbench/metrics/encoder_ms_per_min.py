"""The speaker encoder: CUDA events around its entry on the instance
(``encode_grid_feats`` for the streaming ECAPA grid, whose trunk is called
as a method so module hooks would not fire; ``encode_batch`` for an encoder
on the windowed grid), in ms of the device's stream per minute of audio."""


def install(ctx):
    enc = ctx.pipe.encoder
    name = "encode_grid_feats" if hasattr(enc, "encode_grid_feats") else "encode_batch"
    ctx.wrap(enc, name, ctx.cuda_span("encoder"))


def read(ctx):
    ms = ctx.span_ms("encoder")
    if ms is None or ctx.audio_s <= 0:
        return None
    return ms / ctx.audio_min()
