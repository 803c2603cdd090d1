"""Host-to-device copy time in the traced window, milliseconds per GB the
calls handed the port (1 GB = 1e9 bytes)."""


def read(tr):
    h2d = [e for e in tr.of("gpu_memcpy") if "HtoD" in e.name]
    if not h2d or not tr.bytes_in:
        return None
    ms = sum(min(e.end, tr.t1) - max(e.ts, tr.t0) for e in h2d) * 1e-3
    return ms / (tr.bytes_in / 1e9)
