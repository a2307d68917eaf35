"""95th percentile of the host-clock time from a query's submission to its
answer, over every query answered in the window."""
import statistics


def read(rec):
    lat = rec.latencies_ms
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18]
