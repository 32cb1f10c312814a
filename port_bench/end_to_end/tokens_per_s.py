"""Tokens served in the window (each request's first token and its decoded
ones) over the window's wall, from the first request's start to the last
one's finish."""


def read(ctx):
    wall = ctx.window.end - ctx.window.start
    tokens = sum(ctx.traffic["decode_steps"] + 1 for _ in ctx.served)
    return tokens / wall if ctx.served and wall > 0 else None
