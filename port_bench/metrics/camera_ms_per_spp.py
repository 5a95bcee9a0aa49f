"""Device ms per sample per pixel of the operations the program launches inside
its ``pt.camera_sample`` spans: the counter hash (``ops/rng.py``) and the
camera rays (``ops/camera.py``).  Read from the stretch traced with the
host's operators (``t.host``, a ``harness/spans.SpanTrace``); None where
there is none or it holds no program span."""

from port_bench.harness.spans import camera_ms_per_spp


def value(t):
    return camera_ms_per_spp(getattr(t, "host", None))
