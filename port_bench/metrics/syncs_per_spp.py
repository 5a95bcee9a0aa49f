"""The host's waits on the device (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a synchronous
``cudaMemcpy``) inside the program's ``pt.`` spans, per sample per pixel.
Read from the stretch traced with the host's operators (``t.host``, a
``harness/spans.SpanTrace``); None where there is none or it holds no
program span."""

from port_bench.harness.spans import syncs_per_spp


def value(t):
    return syncs_per_spp(getattr(t, "host", None))
