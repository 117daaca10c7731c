"""step_ms.tput: the host clock from the first sampler step's end to the
last, over the steps between, in the requests the profiler did not run in
(a traced run's later requests), ms."""

from a2bench import window


def read(w):
    return window.step_ms(w)
