"""K1's share of its least time: the FP32 instruction time (21 a pair) or
byte time of the traced requests' inputs (``yardstick.trim_bits_least_s``,
one launch a request), over the device time of ``trim_bits_kernel`` in the
profiler's trace."""

import re

from regbench.yardstick import trim_bits_least_s

_K1 = re.compile(r"\btrim_bits_kernel\b")


def read(layers):
    kernel_s = layers.device_s(lambda name: bool(_K1.search(name)))
    least = trim_bits_least_s([layers.n] * layers.batch, layers.n, layers.device_kind)
    if kernel_s is None or least is None:
        return None
    return 100.0 * least * layers.traced_requests / kernel_s
