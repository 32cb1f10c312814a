"""Host-to-device rate of the window's loads: bytes over h2d over the
chunked pipeline's wall (`bytes_h2d` / `transfer_seconds`), in GB/s.
Nothing to read where no load moved a byte."""


def read(ctx):
    nbytes = sum(s.load[1].bytes_h2d for s in ctx.served)
    secs = sum(s.load[1].transfer_seconds for s in ctx.served)
    return nbytes / secs / 1e9 if nbytes and secs > 0 else None
