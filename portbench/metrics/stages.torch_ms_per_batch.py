"""Device milliseconds a step in kernels that are neither the port's nor
cuFFT's: PyTorch's passes over the audio in the stages."""

LAYER = "stages"
UNIT = "ms"
MOVES = "rtf"


def read(trace):
    ks = trace.kernels("torch")
    if not ks:
        return None
    return 1e3 * sum(d for _, _, d in ks) / trace.steps
