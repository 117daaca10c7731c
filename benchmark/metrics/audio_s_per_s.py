"""audio_s_per_s: seconds of kept audio delivered over the window's wall
(first request's start to last completion, host clock), s/s."""

from a2bench import window


def read(w):
    return window.audio_s_per_s(w)
