"""The port's own spans, for the readers of its ``program_span`` metrics:
the recorder behind ``stage_timer`` (``utils/logging.py::SpanRecorder``).
The first reader that installs puts one recorder in the port's
``RECORDER`` slot through :meth:`TraceContext.wrap`, so the window's
``restore`` takes it out with every other wrapper; readers keep the spans
that opened and closed inside the traced window.  A port without the
recorder installs nothing, and its readers return None."""


def install(ctx) -> None:
    from speech_diarization_tpu_torch.utils import logging as port_logging

    if (not hasattr(port_logging, "SpanRecorder")
            or getattr(ctx, "program_spans", None) is not None):
        return
    rec = ctx.program_spans = port_logging.SpanRecorder()
    ctx.wrap(port_logging, "RECORDER", lambda _: rec)


def in_window(ctx) -> list | None:
    """The closed spans inside the traced window, or None with no
    recorder or no window."""
    rec = getattr(ctx, "program_spans", None)
    if rec is None or ctx.window_s <= 0:
        return None
    lo = round((ctx.t0 + ctx.wall_minus_perf) * 1e9)
    hi = lo + round(ctx.window_s * 1e9)
    return [s for s in rec.spans
            if s.end_ns is not None and lo <= s.start_ns and s.end_ns <= hi]


def outer_waits(ctx, spans: list) -> list:
    """The ``wait`` spans of ``spans`` with no ``wait`` span around them:
    each interval in which the host blocked on the card, once."""
    by_id = ctx.program_spans.by_id()

    def inside_wait(s) -> bool:
        p = s.parent
        while p is not None:
            if by_id[p].wait:
                return True
            p = by_id[p].parent
        return False

    return [s for s in spans if s.wait and not inside_wait(s)]
