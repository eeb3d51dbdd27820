"""Share of its roofline of stage 3's fp32 frozen ViT and VQ: the least
time of a batch (operations at the bf16 peak, so no fp32-accurate route
reads over 100%) over the device time of the kernels launched in the
``perfbench.vit`` ranges. %."""

from perfbench import work

RANGE = ("vit", "IngredientBackbone")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, calls = ctx.trace.layer_device_s("vit"), ctx.trace.calls("vit")
    if not seconds or not calls:
        return None
    cfg, batch = ctx.config, ctx.traffic["batch"]
    least = work.least_seconds(work.vit_flops(cfg, batch), work.vit_bytes(cfg, batch, "float32"))
    return 100.0 * least * calls / seconds
