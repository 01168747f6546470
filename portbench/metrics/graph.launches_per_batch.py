"""Device kernels a step, of every kind."""

LAYER = "entry and chain"
UNIT = "launches"
MOVES = "rtf"


def read(trace):
    ks = trace.kernels()
    if not ks:
        return None
    return len(ks) / trace.steps
