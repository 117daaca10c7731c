"""request_s: the window's wall (host clock) over the requests it
finished, s."""

from a2bench import window


def read(w):
    return window.request_s(w)
