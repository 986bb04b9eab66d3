"""Set-up: process start to the window's start (loading, weights,
warm-up, kernel builds on a checkout's first run)."""


def read(rec):
    return rec.get("setup_s")
