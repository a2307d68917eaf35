"""``correct`` must come out false for the control (the plain reference in
the program's place, one precision lower) and for a run whose timed path
is broken underneath: an answer altered where it is produced, a step that
hands back the previous answer, a repeated answer that differs from the
first.  A sound run of the same small cell comes out true.  Everything here runs the cells
shrunk to a few blocks on the CPU (the program's plain kernels); the
harness's look for a card is skipped."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.cell import check_answers
from perfbench.control import control_check
from perfbench.harness import metrics_of, run_cell

ROWS = 16384
SEED = 2**31 + 77
#: each cell shrunk: few templates
SMALL = {"forest-x10.adhoc": {"templates": 4}}


def run(cell, seconds=0.0):
    return run_cell(cell, SEED, seconds, False, device="cpu", records=ROWS,
                    log=lambda msg: None, mix_overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    from perfbench.cell import load_spec
    out = run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    # every end-to-end metric of the cell but the device's memory and time,
    # which a CPU run has none of
    want = {m["name"] for m in metrics_of(load_spec(), cell, False)}
    assert set(out["metrics"]) == want - {"mem_per_data",
                                          "device_ms_per_query"}


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    c = control_check(cell, SEED, "cpu", 24, records=ROWS,
                      mix_overrides=SMALL[cell])
    assert c["wrong_answers"] > 0 and c["differing_records"] > 0


def flip(words):
    out = np.array(words, copy=True)
    out[0] ^= np.uint32(1)
    return out


def test_altered_answer_from_a_tape(monkeypatch):
    from repro_torch.columnar.device import DeviceTapeBackend
    orig = DeviceTapeBackend.run_tape
    monkeypatch.setattr(DeviceTapeBackend, "run_tape",
                        lambda self, tape: flip(orig(self, tape)))
    out = run("forest-x10.adhoc")
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


def test_a_step_that_hands_back_the_previous_answer(monkeypatch):
    from repro_torch.columnar.device import DeviceTapeBackend
    orig = DeviceTapeBackend.run_tape
    last = []

    def unchanged(self, tape):
        out = orig(self, tape)
        prev = last[-1] if last else out
        last.append(out)
        return prev

    monkeypatch.setattr(DeviceTapeBackend, "run_tape", unchanged)
    out = run("forest-x10.adhoc")
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


def test_a_repeat_that_differs_from_the_first_answer():
    # the window keeps one answer a query: a later answer to the same query
    # is compared with it, and one that differs is wrong
    from perfbench.drivers import Driver
    d = Driver(SimpleNamespace(mix={}))
    first = np.array([5, 7], np.uint32)
    d.note(3, first, 1.0)
    d.note(3, first.copy(), 1.0)
    d.note(3, flip(first), 1.0)
    d.note(3, None, 1.0)              # none came, after an answer did
    d.note(4, None, 1.0)
    assert [a.agrees for a in d.answers] == [True, True, False, True, True]
    assert d.answers[1].words is d.answers[0].words
    assert d.answers[3].words is None and d.answers[4].words is None
    first[0] = 0                      # the kept copy is the driver's own
    assert d.answers[0].words.tolist() == [5, 7]
    ref = SimpleNamespace(n=64, words=lambda tree: np.array([5, 7],
                                                            np.uint32))
    c = check_answers(d.answers, {3: None, 4: None}, ref)
    assert (c["wrong_answers"], c["missing"], c["disagreeing"],
            c["differing"], c["distinct_queries"]) == (3, 2, 1, 0, 1)


def test_each_adhoc_query_is_annotated_in_the_window(monkeypatch):
    # a caller of run_query annotates its tree's selectivities on every
    # call: so does every step of the window
    import repro_torch.columnar as columnar
    calls = []
    orig = columnar.annotate_selectivities

    def counted(tree, table, *a, **kw):
        calls.append(tree)
        return orig(tree, table, *a, **kw)

    monkeypatch.setattr(columnar, "annotate_selectivities", counted)
    out = run("forest-x10.adhoc")
    pool = SMALL["forest-x10.adhoc"]["templates"] * 4
    assert out["correct"] and out["attempted"] == 1
    assert len(calls) == 2 * pool + 1
