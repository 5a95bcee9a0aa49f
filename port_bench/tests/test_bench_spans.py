"""The program's spans read from a hand-written Chrome trace: each device
operation owned through its launch's ``correlation``, backward nodes given
to the span of the forward operator that made them (the ``fwdbwd`` flow,
or the ``Sequence number``), the host's waits counted inside spans, idle
gaps named by the innermost span, the owners a partition of the device
time, and every reader of the benchmark unmoved by the spans' events."""

import json

import pytest

from port_bench.harness import cellkit, core
from port_bench.harness.profile import TraceData
from port_bench.harness.spans import (SpanTrace, camera_ms_per_spp, glue_bwd_ms_per_spp,
                                      syncs_per_spp)
from port_bench.span_report import child_shares

BENCH = core.load_json(core.ROOT, "BENCHMARK.json")


def X(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1, args=args)


def launch(corr, ts, tid=1, name="cudaLaunchKernel"):
    return X("cuda_runtime", name, ts, 2, tid, correlation=corr)


def kernel(corr, name, ts, dur):
    return X("kernel", name, ts, dur, tid=7, correlation=corr)


def sync(ts, dur=10, tid=1):
    return X("cuda_runtime", "cudaStreamSynchronize", ts, dur, tid)


def flow(ph, fid, ts, tid):
    ev = dict(ph=ph, cat="fwdbwd", name="fwdbwd", id=fid, ts=ts, tid=tid, pid=1)
    return dict(ev, bp="e") if ph == "f" else ev


RENDER = [
    X("user_annotation", "port_bench.unit", 1000, 2000),
    X("user_annotation", "port_bench.render", 1000, 1500),
    X("user_annotation", "pt.render", 1010, 1390),
    X("user_annotation", "pt.pack_tables", 1020, 80),
    X("cpu_op", "aten::item", 1050, 40),
    launch(1, 1055, name="cudaMemcpyAsync"),
    X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1060, 5, tid=7, correlation=1),
    sync(1062, 26),
    X("user_annotation", "pt.render_chunk", 1100, 1100),
    X("user_annotation", "pt.camera_sample", 1110, 90),
    launch(2, 1120),
    kernel(2, "void at::native::elementwise_kernel<128, 4>(int)", 1130, 200),
    X("user_annotation", "pt.trace_paths", 1200, 100),
    launch(3, 1210),
    kernel(3, "void (anonymous namespace)::trace_kernel<1>(float*)", 1330, 400),
    X("user_annotation", "pt.accumulate", 1300, 20),
    launch(4, 1305),
    kernel(4, "void at::native::vectorized_elementwise_kernel<4>(int)", 1730, 50),
    X("cpu_op", "aten::item", 2205, 30),
    sync(2210),
    launch(8, 2220),
    kernel(8, "void at::native::elementwise_kernel<128, 2>(int)", 2230, 10),
    X("user_annotation", "pt.tonemap", 2250, 50),
    launch(5, 2260),
    kernel(5, "void at::native::vectorized_elementwise_kernel<4>(int)", 2270, 30),
    X("user_annotation", "port_bench.readout", 2500, 400),
    launch(6, 2510),
    kernel(6, "void at::native::elementwise_kernel<128, 4>(int)", 2520, 40),
    launch(7, 2600, name="cudaMemcpyAsync"),
    X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 2610, 10, tid=7, correlation=7),
    sync(2620, 80),
    X("gpu_memset", "Memset (Device)", 1900, 10, tid=7, correlation=99),  # its launch not kept
]

GRAD = [
    X("user_annotation", "port_bench.unit", 1000, 4000),
    X("user_annotation", "port_bench.step", 1000, 4000),
    X("user_annotation", "pt.loss_and_grad", 1010, 3890),
    X("user_annotation", "pt.forward", 1020, 980),
    X("user_annotation", "pt.camera_sample", 1100, 200),
    X("cpu_op", "aten::select", 1150, 10, **{"Sequence number": 5, "Fwd thread id": 0}),
    flow("s", 77, 1150, 1),
    launch(20, 1155),
    kernel(20, "void at::native::elementwise_kernel<128, 4>(int)", 1200, 100),
    X("cpu_op", "aten::mul", 1200, 10, **{"Sequence number": 6, "Fwd thread id": 0}),
    launch(21, 1205),
    kernel(21, "void at::native::vectorized_elementwise_kernel<4>(int)", 1300, 20),
    X("user_annotation", "pt.trace_paths", 1300, 200),
    X("cpu_op", "TraceDiff", 1305, 10, **{"Sequence number": 7, "Fwd thread id": 0}),
    flow("s", 78, 1305, 1),
    launch(22, 1310),
    kernel(22, "void pt::trace_fwd_kernel_packed<0>(float*)", 1320, 300),
    X("user_annotation", "pt.backward", 2000, 2800),
    X("cpu_op", "autograd::engine::evaluate_function: TraceDiffBackward", 2100, 500, tid=2,
      **{"Sequence number": 7, "Fwd thread id": 1}),
    X("cpu_op", "TraceDiffBackward", 2101, 495, tid=2),
    flow("f", 78, 2101, 2),
    X("user_annotation", "pt.trace_bwd", 2110, 480, tid=2),
    launch(30, 2120, tid=2),
    kernel(30, "void pt::trace_bwd_kernel<0>(float*)", 2130, 1000),
    launch(31, 2200, tid=2),
    kernel(31, "void pt::row_sum_segments(float*)", 3130, 10),
    launch(32, 2595, tid=2),
    kernel(32, "void at::native::elementwise_kernel<128, 4>(int)", 3140, 10),
    X("cpu_op", "autograd::engine::evaluate_function: SelectBackward0", 2700, 100, tid=2,
      **{"Sequence number": 5, "Fwd thread id": 1}),
    X("cpu_op", "SelectBackward0", 2701, 89, tid=2),
    flow("f", 77, 2701, 2),
    launch(40, 2710, tid=2),
    kernel(40, "void at::native::vectorized_elementwise_kernel<4>(int)", 3150, 100),
    X("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 2800, 100, tid=2,
      **{"Sequence number": 6, "Fwd thread id": 1}),
    launch(41, 2810, tid=2),
    kernel(41, "void at::native::vectorized_elementwise_kernel<4>(int)", 3250, 50),
    X("cpu_op", "autograd::engine::evaluate_function: DivBackward0", 2900, 100, tid=2,
      **{"Sequence number": 999, "Fwd thread id": 1}),
    launch(42, 2910, tid=2),
    kernel(42, "void at::native::elementwise_kernel<128, 4>(int)", 3300, 20),
    launch(43, 3100),
    kernel(43, "void at::native::elementwise_kernel<128, 4>(int)", 3320, 10),
    sync(4850, 20),
]

US = 1e-6


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def without_program(events):
    """The fixture as a program without spans would leave it."""
    return [e for e in events if not e["name"].startswith("pt.")]


@pytest.fixture(scope="module")
def context():
    _, cfg = core.load_cell("cornell.render")
    return cellkit.trace_context(cfg, cfg["render"], 24, 16, 4, 3000)


def test_render_ops_are_owned_through_their_launch(tmp_path, context):
    t = SpanTrace.from_chrome(write(tmp_path, RENDER), context)
    got = {k: round(v / US, 6) for k, v in t.device_seconds().items()}
    assert got == {"pt.pack_tables": 5, "pt.camera_sample": 200, "pt.trace_paths": 400,
                   "pt.accumulate": 50, "pt.render": 10, "pt.tonemap": 30,
                   "unattributed": 40 + 10 + 10}
    total = sum(e - s for s, e, _ in t.device_ops)
    assert sum(t.device_seconds().values()) == pytest.approx(total, abs=1e-12)
    assert camera_ms_per_spp(t) == pytest.approx(0.2 / 4)
    assert syncs_per_spp(t) == pytest.approx(2 / 4)  # the readout's wait is not the program's
    assert glue_bwd_ms_per_spp(t) == 0.0
    assert child_shares(t) == {"pt.render": pytest.approx(280 / 290)}


def test_idle_gaps_are_named_by_the_innermost_program_span(tmp_path, context):
    t = SpanTrace.from_chrome(write(tmp_path, RENDER), context)
    gaps = {k: round(v / US, 6) for k, v in t.top_idle_gaps()}
    assert gaps == {"render: python": 60,  # before pt.render opens
                    "render/pt.pack_tables: aten::item": 65,  # the material-id check's wait
                    "render/pt.render_chunk: python": 120 + 320,
                    "render/pt.render: python": 30 + 220,
                    "readout: python": 50 + 380}
    plain = TraceData.from_chrome(write(tmp_path, without_program(RENDER)), context)
    assert {k: round(v / US, 6) for k, v in plain.top_idle_gaps()} == {
        "render: python": 60 + 440 + 250, "render: aten::item": 65, "readout: python": 430}


def test_backward_nodes_go_to_the_span_that_made_them(tmp_path, context):
    t = SpanTrace.from_chrome(write(tmp_path, GRAD), context)
    got = {k: round(v / US, 6) for k, v in t.device_seconds().items()}
    assert got == {"pt.camera_sample": 120, "pt.trace_paths": 300,
                   "pt.trace_bwd": 1010,  # kernel 5 and its row sum stay in pt.trace_bwd
                   "bwd:pt.trace_paths": 10,  # the node's own glue outside pt.trace_bwd
                   "bwd:pt.camera_sample": 100 + 50,  # by the fwdbwd flow, and by the seq no.
                   "pt.backward": 20 + 10}  # a node with no link, and the engine's own
    assert glue_bwd_ms_per_spp(t) == pytest.approx(0.19 / 4)
    assert camera_ms_per_spp(t) == pytest.approx(0.12 / 4)
    assert syncs_per_spp(t) == pytest.approx(1 / 4)
    assert child_shares(t) == {"pt.loss_and_grad": 1.0}


def test_without_a_forward_link_backward_ops_stay_in_the_backward_span(tmp_path, context):
    events = [e for e in GRAD if e["cat"] != "fwdbwd"]
    for e in events:
        e.get("args", {}).pop("Sequence number", None) if e["cat"] == "cpu_op" else None
    t = SpanTrace.from_chrome(write(tmp_path, events), context)
    got = {k: round(v / US, 6) for k, v in t.device_seconds().items()}
    assert got["pt.backward"] == 10 + 100 + 50 + 20 + 10
    assert got["pt.trace_bwd"] == 1010 and not any(k.startswith("bwd:") for k in got)


def test_a_trace_without_program_spans_reads_nothing(tmp_path, context):
    t = SpanTrace.from_chrome(write(tmp_path, without_program(GRAD)), context)
    assert camera_ms_per_spp(t) is None and glue_bwd_ms_per_spp(t) is None
    assert syncs_per_spp(t) is None
    assert camera_ms_per_spp(None) is None


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_reader_reads_the_same_with_and_without_the_spans(tmp_path, context, metric):
    """The device-only stretch's readers, fed the fixtures with and without the
    program's events; the span readers read the host stretch (``t.host``)."""
    mod = core.reader("metrics", metric["name"])
    for events in (RENDER, GRAD):
        got = []
        for evs in (events, without_program(events)):
            t = TraceData.from_chrome(write(tmp_path, evs), context, window_s=5000 * US)
            t.untraced_window_s = 4000 * US
            got.append(mod.value(t))
        assert got[0] == got[1]


@pytest.mark.parametrize("name", ["camera_ms_per_spp.render", "camera_ms_per_spp.grad",
                                  "glue_bwd_ms_per_spp.grad", "syncs_per_spp.render",
                                  "syncs_per_spp.grad"])
def test_span_readers_read_the_host_stretch(tmp_path, context, name):
    mod = core.reader("metrics", name)
    t = TraceData.from_chrome(write(tmp_path, GRAD), context, window_s=5000 * US)
    assert mod.value(t) is None  # no host stretch: a harness that keeps none
    t.host = SpanTrace.from_chrome(write(tmp_path, GRAD, "host.json"), context)
    assert mod.value(t) is not None
    t.host = TraceData.from_chrome(write(tmp_path, GRAD, "host.json"), context)
    assert mod.value(t) is None  # a host stretch read without the program's spans


@pytest.mark.parametrize("cell", ["cornell.render", "cornell.grad"])
def test_span_report_runs_a_tiny_cell(cell):
    """On the CPU no operation runs on a device: the report reads the
    program's spans, no device time and no wait."""
    from port_bench.span_report import report
    from port_bench.tests.bench_tiny import tiny_cell

    wl, cfg = tiny_cell(cell)
    out = report(wl, cfg, 2**31 + 11, 2, device="cpu")
    assert out["device_s"] == out["owners_sum_s"] == 0
    assert out["metrics"]["camera_ms_per_spp"] == 0.0 and out["metrics"]["syncs_per_spp"] == 0.0
    assert out["spp"] == 2 * int(wl["traffic"].get("spp_per_frame", wl["traffic"].get("spp")))
    assert out["window_s"] > 0 and out["trace_bytes"] > 0
