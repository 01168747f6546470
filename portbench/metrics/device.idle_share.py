"""The device's idle share of the traced window: 1 - (union of its
operations' intervals) / (the window's wall), both from one trace."""

LAYER = "device"
UNIT = "%"
MOVES = "rtf"


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
