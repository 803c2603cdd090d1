"""Host waits on the device per call: the CUDA runtime calls that block the
host until the card has finished (stream, device and event synchronize,
synchronous copies), from the traced window's runtime events."""

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def read(tr):
    runtime = tr.of("cuda_runtime")
    if not runtime or not tr.calls:
        return None
    return sum(e.name in WAITS for e in runtime) / tr.calls
