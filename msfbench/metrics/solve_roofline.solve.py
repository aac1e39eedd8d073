"""solve_roofline.solve (%, device trace): the least bytes of the profiled
solves (``bytecount.solve_bytes``: rounds x one round's inputs read once
and outputs written once) over the card's HBM bandwidth, as a share of
the device-busy time inside those solves' ranges. It reads no kernel
name, so it reads the same whatever implements a round."""


def read(r):
    p = r.profile
    reqs = [q for q in r.requests if q.get("profiled")]
    if p is None or p.n_device_events == 0 or len(reqs) != len(p.request_busy_s):
        return None
    busy = sum(p.request_busy_s)
    if busy <= 0:
        return None
    least_s = sum(q["bytes"] for q in reqs) / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / busy
