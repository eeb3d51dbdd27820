"""Images classified by ``predict`` in the window over the window's
seconds. Host clock."""


def read(ctx):
    return ctx.window["images"] / ctx.window["seconds"]
