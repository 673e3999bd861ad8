"""The 90th percentile of every frame's latency in the window, linear
between the order statistics (host clock)."""


def read(run):
    lat = sorted(run.get("frame_latencies") or [])
    if run["kind"] != "refine" or not lat:
        return None
    pos = 0.9 * (len(lat) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(lat) - 1)
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)
