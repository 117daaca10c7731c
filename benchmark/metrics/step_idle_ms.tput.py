"""step_idle_ms.tput: the device's idle time inside the host intervals of
the traced ``"sampler.step"`` ranges, over the number of those ranges, ms
a step."""

from a2bench import spans


def read(w):
    return spans.step_idle_ms(w)
