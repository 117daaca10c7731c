"""step_device_ms.tput: the device time of the program's ``"sampler"``
span over its steps (``last_timings["sampler_device_s"]`` over
``["sampler_steps"]``), summed over the requests the profiler did not run
in, ms a step: ``step_ms.tput`` from inside, on the device clock."""

from a2bench import spans


def read(w):
    return spans.step_device_ms(w)
