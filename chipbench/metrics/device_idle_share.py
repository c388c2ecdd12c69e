"""Share of the traced stretch in which no operation ran on the device:
1 - (the union of device-op intervals / the stretch's host span), in
percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
