"""95th percentile of every gap between consecutive tokens of a request,
over the tokens emitted in the window."""

from perfbench.windows import percentile, token_gaps_ms


def read(rec):
    if rec["kind"] != "serve":
        return None
    return percentile(token_gaps_ms(rec), 95)
