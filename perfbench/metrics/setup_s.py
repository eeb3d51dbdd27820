"""Set-up seconds: the process's start to the first timed step (imports,
CUDA context, the kernel library's load or build, weights and inputs, the
warm-up of the cell's shapes). Host clock."""


def read(ctx):
    return ctx.setup_s
