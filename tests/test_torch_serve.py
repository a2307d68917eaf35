"""The port's serving entry points on the CPU: the request router against
the reference's, the observability endpoints over a durable port session,
and the stream launcher started twice against one durable directory.
"""
import json
import os
import subprocess
import sys
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Atom as RefAtom
from repro.serve.engine import RequestRouter as RefRouter
from repro_torch.columnar import StreamSession, make_forest_table
from repro_torch.core import Atom
from repro_torch.runtime.telemetry import MetricsRegistry, parse_prometheus
from repro_torch.serve import ObservabilityServer, RequestRouter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return {"tier": rng.choice(3, n).astype(np.int32),
            "prompt_tokens": rng.integers(1, 8192, n).astype(np.int32),
            "flagged": rng.choice(2, n, p=[.9, .1]).astype(np.int32)}


def _rules(atom):
    return [(atom("tier", "eq", 2) | atom("prompt_tokens", "lt", 2048))
            & atom("flagged", "eq", 0),
            atom("tier", "eq", 2) & atom("flagged", "eq", 0),
            atom("prompt_tokens", "lt", 2048) & atom("flagged", "eq", 0)]


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("engine", ["numpy", "tape", "jax"])
def test_router_route_matrices_match_reference(engine, persistent):
    ref = RefRouter(_rules(RefAtom), engine=engine, persistent=persistent)
    port = RequestRouter(_rules(Atom), engine=engine, device="cpu",
                         persistent=persistent)
    for call, n in enumerate((3000, 700, 1200)):
        reqs = _requests(n, seed=call)
        want = ref.route({k: v.copy() for k, v in reqs.items()})
        got = port.route(reqs)
        assert got.shape == want.shape == (3, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port.admit(_requests(n, seed=call + 10)),
            ref.admit(_requests(n, seed=call + 10)))
        rs, ps = ref.last_result.stats, port.last_result.stats
        assert ps.logical_atoms == rs.logical_atoms
        assert ps.physical_atoms == rs.physical_atoms
        assert ps.plan_hit_rate == rs.plan_hit_rate
        if engine == "jax":
            assert ps.host_syncs == rs.host_syncs
            assert ps.records_evaluated == rs.records_evaluated
            assert ps.lockstep_rounds == rs.lockstep_rounds > 0


def test_router_defaults_to_the_card():
    router = RequestRouter(_rules(Atom))
    assert router.engine == "tape" and router.device == "cuda"
    with pytest.raises(ValueError):
        RequestRouter([])


def _durable_stream(table, data_dir):
    cfg = StreamSession.DEFAULT_CONFIG.replace(device="cpu", block=1024,
                                               telemetry=MetricsRegistry())
    return StreamSession(table, config=cfg, durable=data_dir)


def _trees(table, n, seed):
    from repro_torch.columnar import random_tree
    rng = np.random.default_rng(seed)
    return [random_tree(table, 4, 2, rng) for _ in range(n)]


def test_httpd_over_a_durable_port_session(tmp_path):
    """/metrics parses (with the WAL gauges and the commit histogram),
    /healthz carries the WAL block and the recovery state, /explain serves
    the retained reports; the recovered session reports its recovery."""
    table = make_forest_table(4000, n_dup=1, seed=7)
    n0 = table.n_records
    data_dir = str(tmp_path / "data")
    ss = _durable_stream(table, data_dir)
    rows = {n: c[:32].copy() for n, c in table.columns.items()}
    ss.append(rows)
    futs = [ss.submit(q) for q in _trees(table, 2, seed=4)]
    for f in futs:
        f.result(timeout=30)
    with ObservabilityServer(ss) as srv:
        metrics = urlopen(f"{srv.url}/metrics", timeout=10).read().decode()
        parsed = parse_prometheus(metrics)
        assert parsed
        assert "repro_wal_commit_ms" in metrics
        assert any(name.startswith("repro_wal_") for name, _ in parsed)
        health = json.loads(urlopen(f"{srv.url}/healthz",
                                    timeout=10).read())
        assert health["ok"] is True and health["durable"] is True
        assert health["wal"]["uncommitted"] == 0    # drain group-committed
        assert health["wal"]["committed_seq"] == ss.sync() == 2
        assert set(health["wal"]) == {"last_seq", "committed_seq",
                                      "uncommitted", "snapshots",
                                      "records_since_snapshot"}
        assert health["recovery"] == {"recovered": False}
        listing = json.loads(urlopen(f"{srv.url}/explain",
                                     timeout=10).read())
        assert set(listing["retained"]) == {f.id for f in futs}
        rep = json.loads(urlopen(f"{srv.url}/explain?id={futs[1].id}",
                                 timeout=10).read())
        assert rep["counters"]["host_syncs"] == 1
        text = urlopen(f"{srv.url}/explain?id={futs[1].id}&format=text",
                       timeout=10).read().decode()
        assert "EXPLAIN ANALYZE" in text
        for path in ("/nope", "/explain?id=abc", "/explain?id=12345"):
            with pytest.raises(HTTPError):
                urlopen(f"{srv.url}{path}", timeout=10)
    ss.close()

    ss2 = _durable_stream(None, data_dir)
    with ObservabilityServer(ss2) as srv:
        health = json.loads(urlopen(f"{srv.url}/healthz",
                                    timeout=10).read())
        rec = health["recovery"]
        assert rec["recovered"] is True and rec["recovery_ms"] > 0
        assert rec["replayed_records"] == 0     # close() snapshotted
        assert health["wal"]["committed_seq"] == 2
        metrics = urlopen(f"{srv.url}/metrics", timeout=10).read().decode()
        assert "repro_recovery_time_ms" in metrics
    assert ss2.table.n_records == n0 + 32
    np.testing.assert_array_equal(
        ss2.table.columns["elevation_0"][-32:], rows["elevation_0"])
    ss2.close()


_LAUNCH = (
    "import json, runpy, sys\n"
    "sys.argv = ['serve'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
    "print(json.dumps(sorted(m for m in sys.modules\n"
    "                        if m.split('.')[0] in ('jax', 'repro'))))\n")


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _LAUNCH, *args], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [], "the launcher loaded jax or repro"
    return lines[:-1]


def test_launcher_durable_restart_recovers_and_warms(tmp_path):
    args = ("--stream", "--device", "cpu", "--durable",
            str(tmp_path / "data"), "--cache-dir", str(tmp_path / "warm"),
            "--serve-port", "0")
    first = _launch(*args)
    assert not any(line.startswith("recovered durable table")
                   for line in first)
    assert "warm restore: {'plans': 0" in "\n".join(first)
    second = _launch(*args)
    rec = [line for line in second
           if line.startswith("recovered durable table")]
    assert rec and rec[0].startswith("recovered durable table: 128 rows")
    warm = [line for line in second if line.startswith("warm restore:")]
    assert warm and "'plans': 0" not in warm[0]
    for out in (first, second):
        assert any(line.startswith("observability endpoints at http://")
                   for line in out)
        assert any(line.startswith("durable: committed seq") for line in out)
        assert "second batch: plan-cache hit rate 100%" in out


@pytest.mark.parametrize("stream", [False, True])
def test_launcher_runs_the_block_engine(stream):
    """``--engine jax`` reaches the router, and with ``--stream`` the
    stream demo too (the reference passes the engine through)."""
    out = _launch(*(("--stream",) if stream else ()), "--engine", "jax",
                  "--device", "cpu")
    assert "second batch: plan-cache hit rate 100%" in out
    assert any(line.startswith("router batch: atom dedupe") for line in out)
    if stream:
        assert any(line.startswith("stream drain 1:") for line in out)
        st = [line for line in out if line.startswith("stream: ")]
        assert st and "degraded 0" in st[0]
