"""idle_pct.<mode>: the share of the traced window in which no operation
ran on the device, 100 * (1 - busy / window), busy being the union of the
device operations' intervals in the profile.  A profile with no device
operation reads nothing."""


def read(rec: dict, name: str) -> float | None:
    tr = rec["trace"]
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / rec["window_s"])
