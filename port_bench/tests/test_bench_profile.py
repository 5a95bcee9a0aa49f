"""The traced stretches' readings from a Chrome trace: the device-only
stretch takes its length from the CUDA events, the idle share its busy time
over the untraced stretch's length, the host stretch its length from the
unit spans, and the idle gaps are named by what the host was doing."""

import json

import pytest

from port_bench.harness.profile import TraceData, short_name
from port_bench.harness.readers import idle_pct, launches_per_spp, other_device_ms_per_spp


def chrome(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [dict(ph="X", **e) for e in events]}))
    return str(path)


KERNELS = [dict(cat="kernel", name="void trace_kernel<1>(float*)", ts=1000, dur=300),
           dict(cat="kernel", name="at::elementwise_kernel<4>(int)", ts=1400, dur=100),
           dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=1600, dur=100)]
CONTEXT = dict(spp=4)


def test_device_only_stretch_takes_its_window_from_the_events(tmp_path):
    t = TraceData.from_chrome(chrome(tmp_path, KERNELS), CONTEXT, window_s=1200e-6)
    assert t.window_s == pytest.approx(1.2e-3) and t.busy_s == pytest.approx(500e-6)
    assert idle_pct(t) is None  # no untraced stretch timed
    t.untraced_window_s = 1000e-6
    assert idle_pct(t) == pytest.approx(50.0)
    assert launches_per_spp(t) == pytest.approx(0.5)
    assert other_device_ms_per_spp(t) == pytest.approx(0.1 / 4)
    assert [n for n, _ in t.top_device_ops()] == ["trace_kernel", "at::elementwise_kernel",
                                                  "Memcpy DtoH"]


def test_host_stretch_is_bounded_by_the_unit_spans_and_names_the_gaps(tmp_path):
    spans = [dict(cat="user_annotation", name="port_bench.unit", ts=900, dur=900),
             dict(cat="user_annotation", name="port_bench.readout", ts=1550, dur=200),
             dict(cat="cpu_op", name="aten::item", ts=1290, dur=80),
             dict(cat="kernel", name="trace_kernel", ts=100, dur=50)]  # before the stretch
    t = TraceData.from_chrome(chrome(tmp_path, KERNELS + spans), CONTEXT)
    assert t.window_s == pytest.approx(900e-6) and t.busy_s == pytest.approx(500e-6)
    gaps = dict(t.top_idle_gaps())
    assert gaps["between units: python"] == pytest.approx(100e-6 + 100e-6)
    assert gaps["between units: aten::item"] == pytest.approx(100e-6)
    assert gaps["readout: python"] == pytest.approx(100e-6)


def test_a_stretch_without_device_work_reads_nothing(tmp_path):
    t = TraceData.from_chrome(chrome(tmp_path, []), CONTEXT, window_s=0.5)
    assert idle_pct(t) is None and launches_per_spp(t) is None
    assert other_device_ms_per_spp(t) is None


def test_short_names():
    assert short_name("void (anonymous namespace)::trace_kernel<(int)1, true>(float*, int)") \
        == "trace_kernel"
