"""Every token the engine emitted in the window (each prefill's first
token and every step's tokens) over the window's seconds; an engine call
that straddles the window's start or close counts by the share of it
inside."""

from perfbench.windows import tokens_in_window, window_s


def read(rec):
    if rec["kind"] != "serve":
        return None
    return tokens_in_window(rec) / window_s(rec)
