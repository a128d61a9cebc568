"""The useful operations of the requests answered in the traced window
over the device's busy time there, as a share of the bf16 dense peak: per
request ResNet-50's forward (the benchmark's own layer shapes) and the
scan's 2 N d; padding slots of a batch are not counted."""

from portbench.reference import bounds, resnet50


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or not t.counts.get("requests"):
        return None
    bb = ctx.config["backbone"]
    rider = resnet50.flops_per_image(bb["image_size"]) + 2 * ctx.config["rows"] * bb["embedding_dim"]
    return 100.0 * t.counts["requests"] * rider / t.busy_s / bounds.BF16_FLOPS
