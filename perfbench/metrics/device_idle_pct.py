"""device_idle_pct (%): 100 minus the share of the traced window in which
some operation (kernel, copy or fill) ran on the card, from the union of
their intervals in the trace."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
