"""Host tail: the ``stage_timer`` records of the host stages after the
device (``segment/``, ``cluster/``, the merges and the overlap rescue in
``pipelines/diarize.py``), summed, in ms per minute of audio completed."""

STAGES = ("vad-post", "scd", "segment-embeddings", "cluster", "merge",
          "reassign", "overlap-rescue")


def read(ctx):
    s = sum(ctx.stage_s.get(k, 0.0) for k in STAGES)
    if s <= 0 or ctx.audio_s <= 0:
        return None
    return 1e3 * s / ctx.audio_min()
