"""``qmatmul``'s share of its roofline: the least time the classifier can
take on the card (``chipbench.counts``: int8 codes and weights in, fp32
logits out, 2 x MACs at the int8 peak) over the device time of its
launches, per batch replayed in the traced stretch."""
from chipbench import counts
from chipbench.kernels import matcher


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays:
        return None
    busy = t.seconds(matcher("qmatmul"))
    if busy <= 0:
        return None
    bound = counts.bound_seconds(ctx.config, ctx.batch, "dense")
    return 100.0 * bound * t.replays / busy
