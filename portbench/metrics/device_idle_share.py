"""device_idle_share (layer: device): 1 - busy / window of the traced
replay, in %; busy is the union of the device operations' intervals."""


def read(r):
    if r.trace is None or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
