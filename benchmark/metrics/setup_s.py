"""``setup_s``: seconds from the run's start to the window's: the
interpreter's imports, the CUDA context, the traffic's pool, the
system under test with its kernels (built on a checkout's first run)
and the warm-up checks."""


def read(ctx):
    return ctx.setup_s
