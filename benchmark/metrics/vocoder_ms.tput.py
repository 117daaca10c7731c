"""vocoder_ms.tput: the device time of the program's ``"vocoder"`` span
(``last_timings["vocoder_device_s"]``, CUDA events), the mean over the
requests the profiler did not run in, ms."""

from a2bench import spans


def read(w):
    return spans.mean_device_ms(w, "vocoder_device_s")
