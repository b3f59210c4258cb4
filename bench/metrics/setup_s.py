"""Set-up: from the process's start (imports, CUDA, the kernels' build on a
first run, weights, the engine, the warm-up traffic) to the window."""


def read(rec):
    return rec.w0 - rec.t_start
