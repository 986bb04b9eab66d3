"""A kind of cell and a plain reference that a later PR adds are found
by their names alone, as new modules beside the others: no file that is
there is edited."""

import sys
import time

import pytest

import perfbench.kinds
import perfbench.reference
from perfbench import core

KIND = '''
import time

from perfbench.model import reference_of


def run(config, mix, seed, seconds, device, trace=None):
    t0 = time.perf_counter_ns()
    answers = [x * x for x in range(int(mix["requests"]))]
    rec = {"kind": "squares", "t0": t0, "t1": time.perf_counter_ns(),
           "answers": answers}
    return rec, {}


def check(config, mix, seed, rec, state, device, control=False):
    ref = reference_of(config)
    return {"wrong_answers": sum(a != ref.square(x)
                                 for x, a in enumerate(rec["answers"]))}


def attempted(rec):
    return len(rec["answers"])


def failed(rec):
    return 0
'''


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A new kind and a new reference in a directory of their own,
    reached through the packages' search paths."""
    kinds, refs = tmp_path / "kinds", tmp_path / "reference"
    kinds.mkdir()
    refs.mkdir()
    tag = tmp_path.name.replace("-", "_")
    names = {"kind": f"squares_{tag}", "reference": f"square_{tag}",
             "wrong": f"wrong_square_{tag}"}
    (kinds / f"{names['kind']}.py").write_text(KIND)
    (refs / f"{names['reference']}.py").write_text(
        "def square(x):\n    return x * x\n")
    (refs / f"{names['wrong']}.py").write_text(
        "def square(x):\n    return x * x + 1\n")
    monkeypatch.setattr(perfbench.kinds, "__path__",
                        [*perfbench.kinds.__path__, str(kinds)])
    monkeypatch.setattr(perfbench.reference, "__path__",
                        [*perfbench.reference.__path__, str(refs)])
    yield names
    for pkg, name in (("kinds", names["kind"]),
                      ("reference", names["reference"]),
                      ("reference", names["wrong"])):
        sys.modules.pop(f"perfbench.{pkg}.{name}", None)


def _resolved(kind, reference):
    return {"cell": {"name": "squares.toy", "chips": 1},
            "config": {"name": "toy", "reference": reference},
            "mix": {"kind": kind, "requests": 5},
            "limits": {"wrong_answers": {"limit": 0}},
            "end_to_end": [{"name": "setup_s", "unit": "s"}],
            "per_layer": []}


@pytest.mark.parametrize("reference, correct",
                         [("reference", True), ("wrong", False)])
def test_a_new_kind_and_reference_are_found_by_name(added, reference,
                                                     correct):
    out = core.run(_resolved(added["kind"], added[reference]), 1, 0.1,
                   False, "cpu", time.perf_counter_ns())
    result = out["result"]
    assert result["correct"] is correct
    assert result["attempted"] == 5
    assert set(result["metrics"]) == {"setup_s"}


def test_an_unknown_kind_is_refused():
    with pytest.raises(ModuleNotFoundError):
        core.kind_module("no_such_kind")
