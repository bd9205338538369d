"""Set-up: process start to the window's start (imports, the kernel
library, weights, the input pool, the statistics pass, warm-up)."""


def read(m):
    return m.setup_s
