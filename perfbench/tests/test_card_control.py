"""The controls, on the card at each cell's own size: the reference put
in the program's place in fp8 (float8 e4m3, one scale per tensor) must
come out not correct, and, for training, a batch with half its rows left
out too. Each case prints its readings as one JSON line (run with -s);
PERF.md gives the readings each limit was set from."""

import json
import time

import pytest

from perfbench import core
from perfbench.kinds import train as train_kind

SEEDS = (1000001, 1000002, 1000003)
SERVE = ("serve.deepseek-llm-7b.long-decode",
         "serve.deepseek-llm-7b.long-prompt")
TRAIN = ("train.smollm2-1.7b.seq2048",)


def _resolved(workload):
    return core.resolve(core.load_json(core.ROOT / "BENCHMARK.json"),
                        workload)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", SERVE)
def test_serve_control_fails(cuda, workload, seed):
    r = _resolved(workload)
    seconds = core.load_json(core.ROOT / "BENCHMARK.json")["run_seconds"]
    out = core.run(r, seed, seconds, False, cuda, time.perf_counter_ns(),
                   control=True)
    compared, extra = out["result"]["compared"], out["extra"]
    print(json.dumps({"workload": workload, "seed": seed,
                      "program": compared["logit_gap"]["value"],
                      "control": extra["control_logit_gap"],
                      "limit": compared["logit_gap"]["limit"],
                      "checked_tokens": extra["checked_tokens"]}))
    assert out["result"]["correct"], compared
    assert extra["control_logit_gap"] > compared["logit_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails(cuda, workload, seed):
    r = _resolved(workload)
    readings = train_kind.control(r["config"], r["mix"], seed, cuda)
    print(json.dumps({"workload": workload, "seed": seed, **readings}))
    for case in ("control", "half_batch"):
        ok, rows = core.judge(dict(readings[case], failed_steps=0),
                              r["limits"])
        assert not ok, (case, rows)
