"""device_idle.tput: one minus the device's busy share of the traced
request (the profiler's device ops), %."""

from a2bench import window


def read(w):
    return window.device_idle(w)
