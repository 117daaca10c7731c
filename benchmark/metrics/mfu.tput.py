"""mfu.tput: the model FLOPs of the requests the profiler did not run in
(a traced run's later requests) over their wall at the card's bf16 peak, %."""

from a2bench import window


def read(w):
    return window.mfu(w)
