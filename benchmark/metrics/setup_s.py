"""setup_s: process start to the first timed request (host clock), s."""


def read(w):
    return w.setup_s
