"""Host waits per call that only steer control: the runtime calls that
``api.host_waits_per_call`` counts, inside a public call's span
(``rf.api.*``) but inside no span of a copy that carries the request's
bytes or its answer (``rf.device.upload``, ``rf.device.readback``): the
start, convergence, domain, final-state and positions-count reads."""

from benchmark import spans


def read(tr):
    prog, runtime = spans.program(tr), tr.of("cuda_runtime")
    if not prog or not runtime or not tr.calls:
        return None
    waits = [e for e in runtime if e.name in spans.WAITS]
    api = [e for e in prog if e.name.startswith(spans.API)]
    copies = [e for e in prog if e.name in spans.COPIES]
    in_api, in_copy = spans.inside(waits, api), spans.inside(waits, copies)
    return sum(a and not c for a, c in zip(in_api, in_copy)) / tr.calls
