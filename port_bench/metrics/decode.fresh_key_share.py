"""Share of the window's decode time in eager steps and captures (a fresh
decode-step key after the params tree was re-assembled), in %: each step's
time is its `done` less the one before it, from the program's
``decode.*`` spans (`pbench/spans.py`).  Nothing to read without them."""
from pbench import spans


def read(ctx):
    return spans.fresh_key_share(spans.window_spans(ctx), ctx.window.start, ctx.window.end)
