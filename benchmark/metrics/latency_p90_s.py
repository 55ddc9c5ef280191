"""latency_p90_s: the 90th percentile, over every request of the window,
of the seconds from ``synthesize`` being called to its mp4 being closed."""

import statistics
import sys


def read(r):
    lat = [u["latency_s"] for u in r.units if "latency_s" in u]
    print(f"latency_p90_s: {len(lat)} requests", file=sys.stderr)
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
