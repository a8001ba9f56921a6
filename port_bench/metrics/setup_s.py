"""Seconds from the process's start to the window's: imports, the kernel
library (built by nvcc on a checkout's first run, loaded after), the
scene, coverage certificates, the scene cache and the warm-up of the
cell's shapes."""

KIND = "end_to_end"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
