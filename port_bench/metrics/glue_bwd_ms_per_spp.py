"""Device ms per sample per pixel of the kernels that are not hand-written and
that autograd's reverse pass launches outside kernel 5: those owned by the
program's ``pt.backward`` span or by a ``bwd:`` span (the forward span that
made the backward node).  Read from the stretch traced with the host's
operators (``t.host``, a ``harness/spans.SpanTrace``); None where there is
none or it holds no program span."""

from port_bench.harness.spans import glue_bwd_ms_per_spp


def value(t):
    return glue_bwd_ms_per_spp(getattr(t, "host", None))
