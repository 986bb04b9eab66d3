"""Mean active slots per decode step in the window: the scheduler's own
counters (DecodeScheduler.stats(): slot_steps over steps), differenced
between the window's start and close."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    steps = rec["stats1"]["steps"] - rec["stats0"]["steps"]
    slot_steps = rec["stats1"]["slot_steps"] - rec["stats0"]["slot_steps"]
    return slot_steps / steps if steps else None
