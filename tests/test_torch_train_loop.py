"""The port's fault-tolerant loop, data pipeline and train launcher on
the CPU: the mirror of the reference's ``tests/test_runtime.py``
(restart bit-exactness, max restarts, the straggler watchdog, replayable
and shardable batches), ``PredicateFilteredDataset`` against the
reference's (the same columns, document ids, filter stats and batches),
and ``python -m repro_torch.launch.train``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.convert import table_from_arrays
from repro_torch.models import api
from repro_torch.models.common import tree_items
from repro_torch.runtime import FailureInjector, StragglerWatchdog, TrainLoop
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]


def make_pieces(tmp_path, fail_at=(), ckpt_every=2, n_async=False):
    cfg = get_smoke("granite-3-8b").replace(microbatch=1)
    params = api.init(cfg, 0, "cpu")
    step = make_train_step(cfg, lr=1e-3)
    state = step.init_state(params)

    def data_fn(step_idx):
        g = torch.Generator().manual_seed(1000 + step_idx)
        return {"tokens": torch.randint(0, cfg.vocab, (2, 33), generator=g)}

    loop = TrainLoop(
        step_fn=step, data_fn=data_fn,
        ckpt=CheckpointManager(str(tmp_path), keep=3, use_async=n_async),
        ckpt_every=ckpt_every,
        injector=FailureInjector(fail_at) if fail_at else None)
    return cfg, params, state, loop


@pytest.mark.parametrize("n_async", [False, True])
def test_restart_is_bit_exact(tmp_path, n_async):
    """A crash + restore replays to exactly the same parameters (and, with
    the async writer, the same optimizer state)."""
    cfg, params, state, loop = make_pieces(tmp_path / "a", n_async=n_async)
    p_ref, s_ref, hist_ref = loop.run(params, state, n_steps=6)

    cfg, params, state, loop2 = make_pieces(tmp_path / "b", fail_at=(4,),
                                            n_async=n_async)
    p_crash, s_crash, hist = loop2.run(params, state, n_steps=6)

    for (_, a), (_, b) in zip(tree_items(p_ref), tree_items(p_crash)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for (_, a), (_, b) in zip(tree_items(s_ref), tree_items(s_crash)):
        assert torch.equal(a, b)
    # loss history after the restart matches the uninterrupted run
    ref_by_step = {h["step"]: h["loss"] for h in hist_ref}
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5]
    for h in hist:
        assert abs(h["loss"] - ref_by_step[h["step"]]) < 1e-6


def test_gives_up_after_max_restarts(tmp_path):
    cfg, params, state, loop = make_pieces(
        tmp_path, fail_at=(1,), ckpt_every=100)  # no ckpt before failure
    loop.max_restarts = 0
    with pytest.raises(RuntimeError):
        loop.run(params, state, n_steps=4)


def test_straggler_watchdog_flags_slow_steps():
    t = [0.0]

    def clock():
        return t[0]

    wd = StragglerWatchdog(alpha=0.5, threshold=3.0, warmup=2, clock=clock)
    flagged = []
    durations = [1.0, 1.0, 1.0, 1.0, 10.0, 1.0, 1.0]
    for i, d in enumerate(durations):
        wd.start()
        t[0] += d
        if wd.stop(i):
            flagged.append(i)
    assert flagged == [4]
    assert wd.flagged_steps == [4]


@pytest.fixture(scope="module")
def port_forest(forest):
    return table_from_arrays(forest.columns)


def test_data_pipeline_replay_deterministic(port_forest):
    from repro_torch.core import Atom
    from repro_torch.data import PredicateFilteredDataset
    expr = (Atom("elevation_0", "gt", 2500.0)
            & (Atom("slope_0", "lt", 20.0) | Atom("wilderness_0", "eq", 1)))
    ds = PredicateFilteredDataset(port_forest, expr, seq_len=16,
                                  global_batch=8, vocab=1000, seed=3)
    b1 = ds(5)
    b2 = ds(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = ds(6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # filter stats recorded and selection is correct
    assert 0 < ds.filter_stats["selected"] < port_forest.n_records
    assert ds.filter_stats["planner"] in ("shallowfish", "deepfish")


def test_data_pipeline_sharding_disjoint(port_forest):
    from repro_torch.core import Atom
    from repro_torch.data import PredicateFilteredDataset
    expr = Atom("elevation_0", "gt", 2000.0) & Atom("slope_0", "lt", 30.0)
    parts = [PredicateFilteredDataset(port_forest, expr, seq_len=8,
                                      global_batch=8, vocab=100, seed=1,
                                      shard_id=i, n_shards=2)
             for i in range(2)]
    b0, b1 = parts[0](0), parts[1](0)
    assert b0["tokens"].shape == (4, 9)
    full = PredicateFilteredDataset(port_forest, expr, seq_len=8,
                                    global_batch=8, vocab=100, seed=1)(0)
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]),
        np.concatenate([full["tokens"][0::2], full["tokens"][1::2]]))


# --- against the reference ---------------------------------------------------
def _datasets(which, forest):
    import repro.core as RC
    import repro.data as RD
    import repro_torch.core as TC
    import repro_torch.data as TD
    if which == "forest":
        def expr(m):
            return ((m.Atom("elevation_0", "gt", 2500.0)
                     & (m.Atom("slope_0", "lt", 20.0)
                        | m.Atom("wilderness_0", "eq", 1)))
                    & m.Atom("aspect_0", "lt", 300.0))
        return (forest, expr(RC), table_from_arrays(forest.columns),
                expr(TC), 16, 1000)
    ref_t = RD.make_corpus_metadata(50_000)
    port_t = TD.make_corpus_metadata(50_000)
    return (ref_t, RD.default_quality_filter(), port_t,
            TD.default_quality_filter(), 128, 49155)


@pytest.mark.parametrize("which", ["forest", "corpus"])
def test_dataset_matches_the_reference(which, forest):
    import repro.data as RD
    import repro_torch.data as TD
    ref_t, ref_e, port_t, port_e, seq, vocab = _datasets(which, forest)
    assert set(port_t.columns) == set(ref_t.columns)
    for name, col in ref_t.columns.items():
        np.testing.assert_array_equal(port_t.columns[name], col)
    for shard in (0, 1):
        kw = dict(seq_len=seq, global_batch=8, vocab=vocab, seed=0,
                  shard_id=shard, n_shards=2)
        rd = RD.PredicateFilteredDataset(ref_t, ref_e, **kw)
        td = TD.PredicateFilteredDataset(port_t, port_e, **kw)
        np.testing.assert_array_equal(td.doc_ids, rd.doc_ids)
        for k in ("planner", "selected", "total", "records_evaluated"):
            assert td.filter_stats[k] == rd.filter_stats[k], k
        for step in range(6):
            got, want = td(step)["tokens"], rd(step)["tokens"]
            assert got.dtype == want.dtype and got.shape == (4, seq + 1)
            np.testing.assert_array_equal(got, want)
    if which == "corpus":
        assert td.filter_stats["planner"] == "deepfish"


# --- the launcher ------------------------------------------------------------
def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path):
    out = _launch("--arch", "granite-3-8b", "--smoke", "--steps", "4",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert any(l.startswith("filter: {'planner': 'deepfish'") for l in lines)
    assert any(l.startswith("done: loss ") and l.endswith(" stragglers")
               for l in lines), out.stdout


def test_launcher_main_returns_what_it_ran(tmp_path):
    from repro_torch.launch.train import main
    res = main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "3",
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in res["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert res["filter_stats"]["selected"] > 0
    assert len(res["timings"]["step_ms"]) == 3
    assert res["cfg"].name == "rwkv6-1.6b-smoke"
    assert res["params"]["embed"].device.type == "cpu"
    assert int(res["opt_state"]["opt"]["step"]) == 3


def test_launcher_refuses_a_mesh(monkeypatch):
    """A mesh whose device count is not the process group's world size
    (torchrun's ``WORLD_SIZE``) is refused before any rank trains."""
    from repro_torch.launch.train import main
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        main(["--arch", "granite-3-8b", "--smoke", "--mesh", "2x2",
              "--device", "cpu"])


def test_launcher_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs there")
    out = _launch("--arch", "granite-3-8b", "--smoke", "--steps", "1",
                  "--ckpt-dir", str(tmp_path))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_runtime_loads_the_loop_lazily():
    code = ("import sys, repro_torch.runtime as r\n"
            "print('repro_torch.runtime.loop' in sys.modules, "
            "'repro_torch.ckpt' in sys.modules)\n"
            "r.TrainLoop\n"
            "print('repro_torch.runtime.loop' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "True"]
