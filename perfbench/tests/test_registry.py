"""BENCHMARK.json against the rules of its format (names, units, keys,
bounds), and every name in it resolving to the files the harness finds
by name."""

import json
import re

import pytest

from perfbench import core
from perfbench.model import reference_of
from perfbench.tests.tiny import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT_KEYS = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
             "num_hidden_layers": "n_layers", "intermediate_size": "d_ff",
             "vocab_size": "vocab", "rope_theta": "rope_theta",
             "rms_norm_eps": "rms_norm_eps"}
REFERENCE_API = ("draw_weights", "fp32_only", "fp8", "Decoder", "served_gaps",
                 "train_steps")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_tok)")


def _cells():
    return [w["name"] for w in spec()["workloads"]]


def test_top_level_keys_and_paths():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["perfbench"]
    assert s["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    s = spec()
    names = [c["name"] for c in s["configs"]] + _cells() + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_every_cell_reports_setup_another_metric_and_a_layer():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for cell in _cells():
        r = core.resolve(s, cell)
        got = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert r["per_layer"]
        for m in r["per_layer"]:
            assert m["moves"] in e2e
            assert m["moves"] in got, (cell, m["name"])


def test_shares_have_an_mfu_beside_each_roofline():
    per_layer = spec()["per_layer"]
    for m in per_layer:
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
            assert any("mfu" in n["name"] and n["moves"] == m["moves"]
                       for n in per_layer)


def test_layers_spelled_alike():
    layers = {}
    for m in spec()["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", _cells())
def test_cell_files_found_by_name(cell):
    r = core.resolve(spec(), cell)
    assert r["config"]["name"] == r["cell"]["config"]
    runner = core.kind_module(r["mix"]["kind"])
    assert all(callable(getattr(runner, f))
               for f in ("run", "check", "attempted", "failed"))
    ref = reference_of(r["config"])
    assert all(callable(getattr(ref, f)) for f in REFERENCE_API)
    assert r["limits"] and all("limit" in v for v in r["limits"].values())
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(core.reader(m["name"]))


def test_configs_state_their_cuts():
    for c in spec()["configs"]:
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert cfg["num_key_value_heads"] == cfg["num_attention_heads"]
        # the published keys keep the published values; the port runs
        # them, except where a departure names the key
        departed = {d.split(":")[0] for d in cfg["departures"]}
        for published, port_key in PORT_KEYS.items():
            same = cfg["port"][port_key] == cfg[published]
            assert same != (published in departed), (c["name"], published)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        core.resolve(spec(), "no.such.cell")
