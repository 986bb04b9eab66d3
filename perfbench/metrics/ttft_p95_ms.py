"""95th percentile, over every request sent in the window, of the time
from its submit to its prefill's token; a failed request counts as
missing (infinitely late)."""

from perfbench.windows import percentile, ttfts_ms


def read(rec):
    if rec["kind"] != "serve":
        return None
    return percentile(ttfts_ms(rec), 95)
