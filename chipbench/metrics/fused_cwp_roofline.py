"""``fused_cwp``'s share of its roofline: the least time its conv blocks
can take on the card (``chipbench.counts``: 1-byte codes in and out,
int8 weights and fp32 bias read once, 2 x MACs at the int8 peak; bands
and halos not counted) over the device time of its launches, per batch
replayed in the traced stretch."""
from chipbench import counts
from chipbench.kernels import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays:
        return None
    busy = t.seconds(matcher("fused_cwp"))
    if busy <= 0:
        return None
    bound = counts.bound_seconds(ctx.config, ctx.batch, "conv_block")
    return 100.0 * bound * t.replays / busy
