"""token_roofline.tput: the least time of the traced GPT-2 token steps
(``a2bench/tokens.py``: float32 block weights and the K/V up to each token
at the HBM peak, or their FLOPs at the float32 peak, one row) over the
device time launched inside the traced ``"seqgen.token"`` ranges, %."""

from a2bench import tokens


def read(w):
    return tokens.token_roofline(w)
