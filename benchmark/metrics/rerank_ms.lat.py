"""rerank_ms.lat: the mean of the program's own rerank time
(``last_timings["rerank_s"]``) over the window's requests, ms; None
without candidates to rerank."""

from a2bench import window


def read(w):
    if w.mix["n_candidate_gen_per_text"] <= 1:
        return None
    return window.mean_timing_ms(w, "rerank_s")
