"""conditioning_ms.tput: the device time of the program's ``"conditioning"`` span
(``last_timings["conditioning_device_s"]``, CUDA events), the mean over the
requests the profiler did not run in, ms."""

from a2bench import spans


def read(w):
    return spans.mean_device_ms(w, "conditioning_device_s")
