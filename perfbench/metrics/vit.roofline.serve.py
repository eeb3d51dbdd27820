"""Share of its roofline of the frozen ViT (layers 0 to the encode layer)
and its VQ in a serving microbatch: the least time (``work.vit_flops`` over
989 TFLOP/s, ``work.vit_bytes`` over 3.35 TB/s, the larger) a call over the
device time of the kernels launched in the ``perfbench.vit`` ranges. %."""

from perfbench import work

RANGE = ("vit", "IngredientBackbone")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, calls = ctx.trace.layer_device_s("vit"), ctx.trace.calls("vit")
    if not seconds or not calls:
        return None
    cfg, batch = ctx.config, ctx.traffic["microbatch"]
    nbytes = work.vit_bytes(cfg, batch, cfg["serve_dtype"])
    least = work.least_seconds(work.vit_flops(cfg, batch), nbytes)
    return 100.0 * least * calls / seconds
