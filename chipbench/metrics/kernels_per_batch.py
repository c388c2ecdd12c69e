"""Device kernels one batch runs: the profiler's kernel launches in the
traced stretch over the batches replayed in it (memcpy and memset are not
kernels and are not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays:
        return None
    n = sum(1 for o in t.device_ops if o.cat == "kernel")
    return n / t.replays if n else None
