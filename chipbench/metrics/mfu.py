"""The whole step's share of the card's int8 peak: useful operations (2 x
MACs of every conv and the fc, counted from the configuration's shapes)
times the images completed in the measured window, over the window's
length times 1,979 TOP/s."""
from chipbench import counts


def read(ctx):
    if ctx.window_s <= 0 or not ctx.images:
        return None
    ops = counts.ops_per_image(ctx.config) * ctx.images
    return 100.0 * ops / (ctx.window_s * counts.INT8_OPS_PER_S)
