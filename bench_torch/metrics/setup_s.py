"""Set-up: from the process's start to the window's first call (imports,
the CUDA context, the kernel library's load or build, the engine's banks
and matrices, the seed's inputs, the warm-up calls); host clock."""


def read(run):
    return run.setup_s
