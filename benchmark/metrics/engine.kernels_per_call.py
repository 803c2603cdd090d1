"""Device kernels launched per call, the port's own and PyTorch's, from
the traced window's kernel events."""


def read(tr):
    kernels = tr.of("kernel")
    if not kernels or not tr.calls:
        return None
    return len(kernels) / tr.calls
