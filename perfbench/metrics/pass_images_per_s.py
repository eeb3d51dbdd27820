"""Images through the frozen-backbone dataset passes in the window (both
passes of stage 3) over the window's seconds. Host clock."""


def read(ctx):
    return ctx.window["images"] / ctx.window["seconds"]
