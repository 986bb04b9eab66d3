"""Tiny sizes of the benchmark's cells, for runs on the CPU: the real
cells' files with the model's widths, the slots and the batch cut. The
tiny served model draws its weights at a larger initializer range, so
that its logits spread as the real models' do (0.1 x sqrt(128) = 1.13 against
0.02 x sqrt(4096) = 1.28) and the logit limits mean the same."""

import copy

from perfbench import core

TINY_PORT = dict(vocab=512, d_model=128, n_heads=4, n_layers=2, d_ff=256,
                 max_seq=256)
TINY_INIT = 0.1


def spec() -> dict:
    return core.load_json(core.ROOT / "BENCHMARK.json")


def tiny(workload: str) -> dict:
    r = copy.deepcopy(core.resolve(spec(), workload))
    r["config"]["port"].update(TINY_PORT)
    mix = r["mix"]
    if mix["kind"] == "train":
        mix.update(batch=4, seq_len=32, pool=4)
    else:
        r["config"]["initializer_range"] = TINY_INIT
        mix.update(slots=4, clients=4, max_len=128, check_prompt_tokens=300)
        mix["prompt_len"].update(median=24, min=8, max=64)
        if mix["output_len"]["dist"] == "uniform":
            mix["output_len"].update(min=2, max=12)
        else:
            mix["output_len"].update(median=8, min=2, max=32)
    return r


def run(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False, resolved=None, control: bool = False) -> dict:
    import time

    return core.run(resolved or tiny(workload), seed, seconds, trace, "cpu",
                    time.perf_counter_ns(), control=control)


SERVE = ("serve.deepseek-llm-7b.long-decode",
         "serve.deepseek-llm-7b.long-prompt")
TRAIN = ("train.smollm2-1.7b.seq2048",)
