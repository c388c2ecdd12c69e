"""Host microseconds a ``BucketGraph.run`` call takes: the median of the
harness's host-clock spans around each call (no sync), taken in short
bursts from an idle device so that the launch queue never fills and a
span is the host's own cost: the copy into the static input, the pad
zeroing and the graph launch."""
import statistics


def read(ctx):
    if not ctx.host_us:
        return None
    return statistics.median(ctx.host_us)
