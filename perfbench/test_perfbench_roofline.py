"""The byte counts behind ``kernel_roofline`` against shapes worked out by
hand, the device trace's reduction on a made-up trace, and the device
time a query costs from a run's record."""
import pytest

from perfbench import devtrace
from perfbench.metrics import roofline_bytes as rb

N = 5_800_000          # the Forest table's real records
BLOCK = 8192
REAL_BLOCKS = 709      # ceil(5.8 M / 8192); the bucket holds 1,024
SET = 4 * 181_250      # one packed set of 5.8 M records: 725,000 B


def test_one_set_is_the_real_records():
    assert rb.set_bytes(N) == SET
    assert rb.set_bytes(32) == 4 and rb.set_bytes(33) == 8


def test_an_atom_over_every_real_record():
    # the column's values of the 709 real blocks, clipped to the 5.8 M
    # real records: the last block's padding and the bucket's 315 empty
    # blocks are not counted
    assert rb.atom_bytes(REAL_BLOCKS, BLOCK, 1, N) == 4 * N == 23_200_000
    assert rb.atom_bytes(REAL_BLOCKS, BLOCK, 1, N) < 4 * 1024 * BLOCK
    # half the blocks touched: their values only
    assert rb.atom_bytes(300, BLOCK, 1, N) == 4 * 300 * BLOCK
    # three applications (a fused chain of three) over every block
    assert rb.atom_bytes(3 * REAL_BLOCKS, BLOCK, 3, N) == 3 * 4 * N


def test_set_operations():
    assert rb.setop_bytes(N, 2, 1) == 3 * SET == 2_175_000


def test_a_windows_work():
    counters = {"blocks_touched": 1000.0, "atom_applications": 4.0,
                "setops": 10 + 2 * 3,       # 10 two-operand, 3 stacked Q=2
                "launches_by_q": {"bitmap_inter_multi": {"2": 3},
                                  "bitmap_union_reduce": {"4": 2}}}
    want = (4 * 1000 * BLOCK           # the atoms' column values
            + 10 * 3 * SET             # two-operand set operations
            + 3 * (3 + 2) * SET        # stacked AND: a and 2 sets, 2 out
            + 2 * (4 + 1) * SET)       # OR-reduce of 4: 4 in, 1 out
    assert rb.window_bytes(counters, N, BLOCK) == want


def test_no_work_no_bytes():
    assert rb.window_bytes({}, N, BLOCK) == 0


def test_nested_spans_label_the_innermost():
    spans = [("outer", 0, 100), ("mid", 10, 50), ("inner", 20, 30),
             ("late", 60, 200)]
    assert devtrace._timeline(spans) == [
        (0, 10, "outer"), (10, 20, "mid"), (20, 30, "inner"),
        (30, 50, "mid"), (50, 60, "outer"), (60, 100, "late")]


def test_op_names():
    assert devtrace.op_name(
        "void predicate_scan_multi_kernel<4>(float const*, int)") == \
        "predicate_scan_multi"
    assert devtrace.op_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
    assert devtrace.op_name(
        "void at::native::(anonymous namespace)::foo_kernel<int>(int)") == \
        "at::native::foo_kernel"


def test_summary_of_a_made_up_trace(monkeypatch):
    # device clock = host ns + 1,000; the marker ran at host 1,000 ns
    ns = 1_000_000_000
    evs = [("spin_kernel", 500, 600), ("spin_kernel", 2_000, 2_100),
           ("void predicate_scan_kernel(int)", ns + 1_000, ns + 11_000),
           ("void bitmap_setop_kernel(int)", ns + 5_000, ns + 21_000),
           ("Memcpy DtoH (Device -> Pageable)", ns + 41_000, ns + 51_000)]
    monkeypatch.setattr(devtrace, "_events", lambda prof: evs)
    dt = devtrace.DeviceTrace()
    dt.prof, dt.mark_ns = None, 1_000
    host = [("run_query", 1.0, 1.0 + 100e-6), ("plan", 1.0 + 20e-6,
                                              1.0 + 40e-6)]
    s = dt.summary(1.0, 1.0 + 100e-6, host)
    ns_ = pytest.approx
    assert s["window_s"] == ns_(100e-6, abs=2e-9)
    assert s["busy_s"] == ns_(30e-6, abs=2e-9)      # 0-20 us, 40-50 us
    assert s["port_kernel_s"] == ns_(26e-6, abs=2e-9)
    assert s["port_launches"] == {"predicate_scan": 1, "bitmap_setop": 1}
    assert s["idle"] == ns_({"plan": 20e-6, "run_query": 50e-6}, abs=2e-9)


def test_device_time_a_query():
    from types import SimpleNamespace

    from perfbench.harness import metric_reader
    read = metric_reader("device_ms_per_query")
    trace = {"busy_s": 0.002, "window_s": 0.05}
    assert read(SimpleNamespace(answered=4, trace=trace)) == \
        pytest.approx(0.5)
    # a CPU run has no device trace; a window that answered nothing, no cost
    assert read(SimpleNamespace(answered=4, trace=None)) is None
    assert read(SimpleNamespace(answered=0, trace=trace)) is None
