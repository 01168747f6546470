"""The port's CUDA kernels' share of their roofline: the least time of
every launch in the traced steps (``roofline.WORK`` at the launch's own
arguments) over the device time of the port's kernels in the same
steps."""

LAYER = "kernels"
UNIT = "%"
MOVES = "rtf"


def read(trace):
    busy = sum(d for _, _, d in trace.kernels("port"))
    if busy <= 0 or not trace.bound_s:
        return None
    return 100.0 * trace.bound_s / busy
