"""token_idle_ms.tput: the device's idle time inside the host intervals of
the traced ``"seqgen.token"`` ranges, over the number of those ranges, ms
a generated GPT-2 token."""

from a2bench import tokens


def read(w):
    return tokens.token_idle_ms(w)
