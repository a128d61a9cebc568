"""The indexing step's share of the bf16 dense peak in the traced window:
ResNet-50's forward operations (the benchmark's own layer shapes) for
every image embedded in it, over its seconds."""

from portbench.reference import bounds, resnet50


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.counts.get("images"):
        return None
    flops = resnet50.flops_per_image(ctx.config["backbone"]["image_size"]) * t.counts["images"]
    return 100.0 * flops / t.window_s / bounds.BF16_FLOPS
