"""Share of the device's busy time spent outside the program's four
hand-written CUDA kernels: activation quantization, absmax, band slab
copies, ``torch.cat``, the copy into the graph's static input and the
logits copy, in percent of the summed device-op time of the stretch."""
from chipbench.kernels import is_port_kernel


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    total = sum(o.dur for o in t.device_ops)
    if total <= 0:
        return None
    port = sum(o.dur for o in t.device_ops if is_port_kernel(o.name))
    return 100.0 * (total - port) / total
