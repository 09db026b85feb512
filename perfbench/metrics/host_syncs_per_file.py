"""Device waits: the spans of the port in which the host blocks on the card
(``wait=True``, none counted inside another), per file: the waits that
carry a file id over the number of file ids among the window's spans."""
from perfbench.metrics import _program_spans


def install(ctx):
    _program_spans.install(ctx)


def read(ctx):
    spans = _program_spans.in_window(ctx)
    files = {s.file for s in spans or () if s.file is not None}
    if not files:
        return None
    waits = [s for s in _program_spans.outer_waits(ctx, spans) if s.file is not None]
    return len(waits) / len(files)
