"""Share of the window's prefills the host spent dispatching, in %: the
``prefill`` span's host duration over the time to its completion, the
latest ``done`` of its children (`pbench/spans.py`).  A diagnostic: near
100 % the host sets the prefill's pace (a graphed or trimmed dispatch
lowers it); a faster kernel in a prefill already bound by the device
raises it.  Nothing to read without the program's spans."""
from pbench import spans


def read(ctx):
    return spans.prefill_host_share(spans.window_spans(ctx), ctx.window.start, ctx.window.end)
