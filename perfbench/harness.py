"""One run of one cell: the data from the seed, the program's set-up and
warm-up, the measured window, the check against the plain reference, and
the result line's fields.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (its
``entry`` names the driver, ``drivers/<entry>.py``) and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional


from .cell import HERE, check_answers, make_context
from .reference import Reference

#: capacity of the program's span ring in a traced run (a window's spans
#: must all stay in it)
SPAN_CAPACITY = 1 << 20


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = f"perfbench.metrics.{name}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, workload: str, trace: bool) -> List[dict]:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


@dataclass
class RunRecord:
    """What the metric readers read."""

    answered: int
    window_s: float
    setup_s: float
    latencies_ms: List[float]
    memory_peak_bytes: int
    n_records: int
    attributes: int
    value_bytes: int
    block: int
    device_kind: str
    counters: Dict
    trace: Optional[Dict]


def delta(a: Dict, b: Dict) -> Dict:
    """``b - a`` of nested counter dicts."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out[k] = {kk: vv for kk, vv in delta(a.get(k, {}), v).items()
                      if vv}
        else:
            out[k] = v - a.get(k, 0)
    return out


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def host_clocks() -> Dict[str, float]:
    """Wall, process and main-thread CPU clocks, read at both ends of the
    window: whether a slow run lost its time off the CPU or on it."""
    return {"wall": time.perf_counter(), "process": time.process_time(),
            "thread": time.thread_time()}


def quarter_rates(steps, t0: float, t1: float) -> List[float]:
    """Answers a second in each quarter of the window ``[t0, t1]``, from
    ``(end of a step, answers so far)`` pairs: whether the rate drifts
    within a run."""
    out, done = [], 0
    for q in range(1, 5):
        edge = t0 + (t1 - t0) * q / 4
        now = max([n for t, n in steps if t <= edge], default=0)
        out.append(round((now - done) / ((t1 - t0) / 4), 3))
        done = now
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", records: Optional[int] = None,
             t_start: Optional[float] = None, log=print,
             mix_overrides: Optional[dict] = None) -> Dict:
    """One run of ``workload``.  ``records`` and ``mix_overrides`` shrink
    the cell (the CPU tests' small tables); ``device="cpu"`` runs the
    program's plain kernels (tests only: the command refuses to run without
    a card).  Returns the result line's fields, the compared numbers last."""
    import torch

    from .devtrace import DeviceTrace, top
    from .drivers import driver_class
    t_start = time.perf_counter() if t_start is None else t_start
    t_data = time.perf_counter()
    spec, cell, ctx = make_context(workload, seed, device, records,
                                   mix_overrides)
    t_data = time.perf_counter() - t_data
    cfg, data, pool = ctx.cfg, ctx.data, ctx.pool
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from repro_torch.columnar import Tracer
        ctx.tracer = Tracer(capacity=SPAN_CAPACITY)
    driver = driver_class(ctx.mix["entry"])(ctx)
    t_prog = time.perf_counter()
    driver.setup()
    t_prog = time.perf_counter() - t_prog
    if ctx.tracer is not None:
        ctx.tracer.drain()
    if cuda:
        torch.cuda.synchronize()
    c0 = driver.counters()
    # the device is traced in every run on a card (the end-to-end device
    # time comes from it); ``trace`` adds the program's spans and selects
    # the per-layer metrics
    dt = DeviceTrace() if cuda else None
    with dt if dt is not None else nullcontext():
        n0 = len(driver.answers)
        steps = []            # (end of a step, answers so far), for the log
        h0 = host_clocks()
        t0 = time.perf_counter()
        while True:
            driver.step()
            t1 = time.perf_counter()
            steps.append((t1, len(driver.answers) - n0))
            if t1 - t0 >= seconds:
                break
        h1 = host_clocks()
    setup_s = t0 - t_start
    window_s = t1 - t0
    c1 = driver.counters()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    answers = driver.answers[n0:]
    # the harness's spans and the program's, which label the idle gaps
    timeline = [s for s in driver.spans if s[1] >= t0]
    if ctx.tracer is not None:
        timeline += [(sp.name, sp.t0, sp.t0 + sp.dur_ms / 1e3)
                     for sp in ctx.tracer.drain() if sp.t0 >= t0]
    summary = dt.summary(t0, t1, timeline) if dt is not None else None
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    rec = RunRecord(
        answered=sum(1 for a in answers if a.words is not None),
        window_s=window_s, setup_s=setup_s,
        latencies_ms=[a.latency_ms for a in answers],
        memory_peak_bytes=peak, n_records=data.n_records,
        attributes=cfg["attributes"], value_bytes=cfg["value_bytes"],
        block=cfg["block"], device_kind=kind,
        counters=delta(c0, c1), trace=summary)
    trees = pool.trees
    driver_times = driver.times
    driver.close()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    reference = Reference(data.columns, device=device)
    check = check_answers(answers, trees, reference)
    reference.release()
    check_s = time.perf_counter() - t_check
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        value = metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(check["wrong_answers"] == 0 and rec.answered),
           "attempted": len(answers),
           "failed": sum(1 for a in answers if a.words is None),
           "metrics": metrics, "device": device_info}
    if trace and summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": top(summary["ops"]),
                            "idle_gaps": top(summary["idle"])}
    out["checks"] = {"wrong_answers": {"value": check["wrong_answers"],
                                       "limit": 0}}
    lat = rec.latencies_ms
    log(f"cell {workload} seed {seed}: {rec.answered} answered in "
        f"{window_s:.3f} s ({len(answers)} sent), set-up {setup_s:.3f} s, "
        f"check {check_s:.3f} s over {check['distinct_queries']} distinct "
        f"queries; latency ms p50 "
        f"{statistics.median(lat) if lat else 0:.3f}; peak {peak} B; "
        f"device {kind} ({power_limit() if cuda else 'no card'})")
    log(f"set-up: imports and start {setup_s - t_data - t_prog:.3f} s, "
        f"data and queries {t_data:.3f} s, the program's set-up and "
        f"warm-up {t_prog:.3f} s ({json.dumps(driver_times)})")
    log(f"queries a second in each quarter of the window: "
        f"{quarter_rates(steps, t0, t1)}")
    log(f"host clocks over the window, s: "
        f"{json.dumps({k: round(h1[k] - h0[k], 6) for k in h1})}")
    log(f"counters over the window: {json.dumps(rec.counters)}")
    if summary is not None:
        log(f"trace: busy {summary['busy_s']:.6f} s of "
            f"{summary['window_s']:.6f} s, port kernels "
            f"{summary['port_kernel_s']:.6f} s, port launches seen "
            f"{summary['port_launches']}")
    log(f"check: {json.dumps(check)}")
    return out
