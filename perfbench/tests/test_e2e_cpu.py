"""Whole runs of each kind of cell at tiny sizes on the CPU (the port's
plain paths), past the harness's look for a card: a sound run comes out
correct with its metrics; the timed path broken underneath, in each way
the cell can break, comes out not correct."""

import json

import pytest
import torch

from perfbench.tests import tiny

HOST_METRICS = {
    ("serve.deepseek-llm-7b.long-decode", False):
        {"output_tokens_per_s", "itl_p95_ms", "setup_s"},
    ("serve.deepseek-llm-7b.long-prompt", False):
        {"output_tokens_per_s", "itl_p95_ms", "ttft_p95_ms", "setup_s"},
    ("train.smollm2-1.7b.seq2048", False): {"train_tokens_per_s", "setup_s"},
    ("serve.deepseek-llm-7b.long-decode", True):
        {"sched.mean_occupancy", "engine.step_ms", "mfu.serve"},
    ("serve.deepseek-llm-7b.long-prompt", True):
        {"sched.mean_occupancy", "engine.step_ms", "mfu.serve",
         "engine.prefill_ms_per_ktok", "mfu.prefill"},
    ("train.smollm2-1.7b.seq2048", True): {"mfu.train"},
}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.SERVE + tiny.TRAIN)
def test_a_sound_run_is_correct(cell, trace):
    out = tiny.run(cell, trace=trace)
    result = out["result"]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    # the CPU has no device trace: only host-clock and counter metrics
    assert set(result["metrics"]) == HOST_METRICS[(cell, trace)]
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "compared"
    assert result["device"]["platform"] == "cpu"
    json.dumps(result)


def test_the_same_seed_serves_the_same_tokens():
    cell = tiny.SERVE[1]
    a = tiny.run(cell, seed=77)["record"]["requests"]
    b = tiny.run(cell, seed=77)["record"]["requests"]
    first = {(r.client, r.rnd): r.tokens for r in a if r.tokens}
    again = {(r.client, r.rnd): r.tokens for r in b if r.tokens}
    common = set(first) & set(again)
    assert len(common) >= 4
    assert all(first[k] == again[k] for k in common)


@pytest.mark.parametrize("cell", tiny.SERVE)
def test_an_altered_token_is_caught(cell, monkeypatch):
    from ray_tpu_torch.serve import decode_scheduler

    step = decode_scheduler.TorchSlotEngine.step

    def altered(self, tokens):
        out = step(self, tokens)
        slot = min(out)
        out[slot] = (out[slot] + self._cfg.vocab // 2) % self._cfg.vocab
        return out

    monkeypatch.setattr(decode_scheduler.TorchSlotEngine, "step", altered)
    result = tiny.run(cell)["result"]
    assert not result["correct"]
    assert result["compared"]["logit_gap"]["value"] > \
        result["compared"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", tiny.SERVE)
def test_half_the_slots_left_out_is_caught(cell, monkeypatch):
    """The step's second half of the slots never computed: their
    requests get their last token again."""
    from ray_tpu_torch.serve import decode_scheduler

    step = decode_scheduler.TorchSlotEngine.step

    def half(self, tokens):
        out = step(self, tokens)
        return {s: (t if s < self.slots // 2 else tokens[s])
                for s, t in out.items()}

    monkeypatch.setattr(decode_scheduler.TorchSlotEngine, "step", half)
    assert not tiny.run(cell)["result"]["correct"]


@pytest.mark.parametrize("cell", tiny.SERVE)
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, monkeypatch):
    """The decode step's cache returned as it came: no K/V written, no
    position advanced."""
    from ray_tpu_torch.models import decode

    step = decode.slot_decode_step

    def stuck(params, cache, token, active, cfg):
        k, v, pos = cache["k"].clone(), cache["v"].clone(), cache["pos"]
        logits, cache = step(params, cache, token, active, cfg)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        cache["pos"] = pos
        return logits, cache

    monkeypatch.setattr(decode, "slot_decode_step", stuck)
    assert not tiny.run(cell)["result"]["correct"]


def test_a_step_that_leaves_the_parameters_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result = tiny.run(tiny.TRAIN[0])["result"]
    assert not result["correct"]
    assert result["compared"]["update_norm_gap"]["value"] == pytest.approx(1)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from ray_tpu_torch.models import transformer

    loss_fn = transformer.loss_fn

    def half(params, batch, cfg, pcfg=transformer.ParallelConfig()):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, {k: v[:rows] for k, v in batch.items()}, cfg,
                       pcfg)

    monkeypatch.setattr(transformer, "loss_fn", half)
    assert not tiny.run(tiny.TRAIN[0])["result"]["correct"]


@pytest.mark.parametrize("cell", tiny.SERVE)
def test_the_fp8_control_reads_above_the_program(cell):
    out = tiny.run(cell, control=True)
    assert out["extra"]["control_logit_gap"] > \
        out["result"]["compared"]["logit_gap"]["value"]


def test_the_training_controls_read_above_the_program():
    from perfbench.kinds import train as train_kind

    r = tiny.tiny(tiny.TRAIN[0])
    program = tiny.run(tiny.TRAIN[0], resolved=r)["result"]["compared"]
    readings = train_kind.control(r["config"], r["mix"], 2 ** 31 + 11,
                                  "cpu")
    for case in ("control", "half_batch"):
        assert any(readings[case][k] > program[k]["value"]
                   for k in ("loss_gap", "grad_norm_gap"))
