"""The kernels' share of their roofline, in percent: the least time the
window's work needs (each input byte read once and each answer byte
written once at the card's memory rate, from the calls' own sizes) over
the summed device time of every kernel in the window. Copies are not
kernels: the upload is the device layer's."""

from benchmark.trace import bound_s


def read(tr):
    busy = sum(min(e.end, tr.t1) - max(e.ts, tr.t0) for e in tr.of("kernel")) * 1e-6
    if busy <= 0 or not tr.bytes_in:
        return None
    return 100.0 * bound_s(tr.bytes_in, tr.bytes_out) / busy
