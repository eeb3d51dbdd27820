"""Images of every training step completed in the window over the window's
seconds (closed loop, ended by a synchronize). Host clock."""


def read(ctx):
    return ctx.window["images"] / ctx.window["seconds"]
