"""The port's kernels against the bandwidth bound, in percent: the least
time the window's predicate work could take at the card's published HBM
bandwidth (``roofline_bytes.window_bytes``) over the time the profiler saw
the port's own kernels run."""
from .roofline_bytes import PEAK_BYTES_PER_S, window_bytes


def read(rec):
    t = rec.trace
    peak = PEAK_BYTES_PER_S.get(rec.device_kind)
    if not t or not peak or t["port_kernel_s"] <= 0:
        return None
    need = window_bytes(rec.counters, rec.n_records, rec.block,
                        rec.value_bytes)
    if need <= 0:
        return None
    return 100.0 * need / peak / t["port_kernel_s"]
