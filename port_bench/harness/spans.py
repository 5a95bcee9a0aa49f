"""The program's own spans in a stretch traced with the host's operators, and
the device time, launches and host waits that fall under each.

The program names the layers of a frame and of a gradient step with
``record_function`` spans whose names start with ``pt.`` while a profiler
records (``pathtracer_tpu_torch/utils/metrics.span``).  :class:`SpanTrace`
is a ``profile.TraceData`` of such a stretch that also keeps:

- the ``pt.`` spans, on every thread;
- each device operation's launch: the host time of the ``cuda_runtime``
  (or ``cuda_driver``) event with the operation's ``correlation``;
- autograd's backward nodes (``autograd::engine::evaluate_function:
  *Backward*``) and, for each, the start of the forward operator that made
  it: the profiler's ``fwdbwd`` flow, or else the ``Sequence number`` the
  two share;
- the host's waits on the device: ``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the synchronous
  ``cudaMemcpy``.

:meth:`SpanTrace.owner` gives a launch one owner.  It is the innermost ``pt.``
span whose interval holds the launch, on any thread.  A launch inside a
backward node (on any thread: the host runs one node at a time), where no ``pt.`` span opened inside that node holds it, is
owned by ``bwd:`` plus the span of the forward operator that made the node.
Where the trace has no link for that node, its launches stay in the span
around it (``pt.backward``).  A device operation with no launch in the trace
or no span around its launch is :data:`UNATTRIBUTED`.  Every device operation
of the stretch has exactly one owner, so the owners' device times sum to
the stretch's.  Kernel durations are the device's own, as in the
device-only stretch; only the idle time between them grows with the
profiler's host cost.
"""

from __future__ import annotations

import bisect
import json
import re

from port_bench.harness.profile import DEVICE_CATS, TraceData, short_name
from port_bench.harness.readers import HAND_PATTERN

PROGRAM_PREFIX = "pt."
BACKWARD_PREFIX = "bwd:"
UNATTRIBUTED = "unattributed"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NODE_PREFIX = "autograd::engine::evaluate_function: "
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
_HAND = re.compile(HAND_PATTERN)


def is_hand_kernel(name: str) -> bool:
    """A kernel of the program's CUDA sources (``readers.HAND_KERNELS``)."""
    return bool(_HAND.fullmatch(short_name(name).split("::")[-1]))


class _Intervals:
    """``(start, end, payload)`` intervals that nest or are disjoint; finds
    the innermost one holding a time."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))  # an outer one before its inner
        self.starts = [s for s, _, _ in self.items]

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            s, e, payload = self.items[i]
            if s <= t < e:
                return self.items[i]
        return None


class SpanTrace(TraceData):
    """A stretch traced with the host's operators, with the program's spans."""

    pt_spans = _Intervals([])
    nodes = _Intervals([])  # backward nodes; payload: the start of the forward operator
    launches = {}  # correlation -> host time of the launch
    device_corr = []  # (start, end, name, correlation, category) of its device operations
    syncs = []  # host times of the waits on the device

    @classmethod
    def from_chrome(cls, path: str, context: dict, window_s=None) -> "SpanTrace":
        t = super().from_chrome(path, context, window_s)
        with open(path) as f:
            events = json.load(f)
        t.read_program(events.get("traceEvents", events) if isinstance(events, dict) else events,
                       window_s is None)
        return t

    def read_program(self, events, bounded: bool = True):
        """Keep what the module docstring lists from the trace's events;
        ``bounded``: the stretch is the unit spans' interval, so only the
        device operations overlapping it count (as ``TraceData`` counts)."""
        spans, nodes, launches, device, syncs = [], {}, {}, [], []
        flow_start, flow_end, forward_ops = {}, {}, {}
        for ev in events:
            ph, cat, name = ev.get("ph"), ev.get("cat", ""), ev.get("name", "")
            if cat == "fwdbwd" and ph in ("s", "f"):
                (flow_start if ph == "s" else flow_end)[ev.get("id")] = (
                    float(ev["ts"]) * 1e-6, ev.get("tid"))
                continue
            if ph != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev["dur"]) * 1e-6
            args = ev.get("args") or {}
            if cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
                spans.append((s, e, name))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launches.setdefault(args["correlation"], s)
                if name in SYNC_CALLS:
                    syncs.append(s)
            elif cat in DEVICE_CATS:
                device.append((s, e, name, args.get("correlation"), cat))
            elif cat == "cpu_op":
                seq = args.get("Sequence number")
                if name.startswith(NODE_PREFIX) and "Backward" in name:
                    nodes.setdefault(ev.get("tid"), []).append([s, e, seq])
                elif seq is not None and not args.get("Fwd thread id"):
                    forward_ops.setdefault(seq, []).append(s)
        ends = {}  # tid -> sorted flow ends (time, id)
        for fid, (ts, tid) in flow_end.items():
            ends.setdefault(tid, []).append((ts, fid))
        for tid, node_list in nodes.items():
            tid_ends = sorted(ends.get(tid, []))
            times = [ts for ts, _ in tid_ends]
            for node in node_list:
                s, e, seq = node
                i = bisect.bisect_left(times, s)
                fwd = None
                if i < len(times) and times[i] < e and tid_ends[i][1] in flow_start:
                    fwd = flow_start[tid_ends[i][1]][0]
                elif seq is not None:
                    before = [x for x in forward_ops.get(seq, []) if x < s]
                    fwd = max(before) if before else None
                node[2] = fwd
        self.pt_spans = _Intervals(spans)
        self.nodes = _Intervals(tuple(n) for v in nodes.values() for n in v)
        self.launches = launches
        if bounded:
            device = [d for d in device if d[1] > self.start and d[0] < self.end]
        self.device_corr = device
        self.syncs = sorted(syncs)

    def span_at(self, t):
        """The name of the innermost program span holding the time ``t``, or None."""
        hit = self.pt_spans.innermost(t)
        return hit[2] if hit else None

    def owner(self, correlation) -> str:
        """The owner of the device operation launched by ``correlation``."""
        if correlation not in self.launches:
            return UNATTRIBUTED
        t = self.launches[correlation]
        span = self.pt_spans.innermost(t)
        node = self.nodes.innermost(t)
        if node is not None and (span is None or span[0] < node[0]) and node[2] is not None:
            made_in = self.span_at(node[2])
            if made_in is not None:
                return BACKWARD_PREFIX + made_in
        return span[2] if span else UNATTRIBUTED

    def has_program_spans(self) -> bool:
        return any(s < self.end and e > self.start for s, e, _ in self.pt_spans.items)

    def device_seconds(self, glue_only: bool = False) -> dict:
        """``{owner: seconds}`` of the stretch's device operations, or with
        ``glue_only`` of its kernels that are not hand-written."""
        out = {}
        for s, e, name, corr, cat in self.device_corr:
            if glue_only and (cat != "kernel" or is_hand_kernel(name)):
                continue
            k = self.owner(corr)
            out[k] = out.get(k, 0.0) + (e - s)
        return out

    def syncs_in_spans(self) -> int:
        """The host's waits on the device inside the stretch and inside a program span."""
        return sum(1 for t in self.syncs
                   if self.start <= t < self.end and self.span_at(t) is not None)

    def host_states(self, times) -> list:
        """As ``TraceData.host_states``, with the innermost program span
        after the harness's span: ``render/pt.pack_tables: aten::item``."""
        out = []
        for t, state in zip(times, super().host_states(times)):
            span = self.span_at(t)
            if span is not None:
                where, op = state.split(": ", 1)
                state = f"{where}/{span}: {op}"
            out.append(state)
        return out


def _spans_of(t):
    """``t`` where it is a :class:`SpanTrace` holding program spans, else None."""
    return t if isinstance(t, SpanTrace) and t.has_program_spans() else None


def camera_ms_per_spp(t):
    """Device ms per sample per pixel of the operations launched inside
    ``pt.camera_sample``: the counter hash and the camera rays."""
    t = _spans_of(t)
    if t is None or not t.context.get("spp"):
        return None
    return t.device_seconds().get(PROGRAM_PREFIX + "camera_sample", 0.0) * 1e3 / t.context["spp"]


def glue_bwd_ms_per_spp(t):
    """Device ms per sample per pixel of the kernels that are not
    hand-written and are owned by ``pt.backward`` or a ``bwd:`` span:
    autograd's reverse pass outside kernel 5 (``pt.trace_bwd``)."""
    t = _spans_of(t)
    if t is None or not t.context.get("spp"):
        return None
    got = t.device_seconds(glue_only=True)
    glue = sum(v for k, v in got.items()
               if k == PROGRAM_PREFIX + "backward" or k.startswith(BACKWARD_PREFIX))
    return glue * 1e3 / t.context["spp"]


def syncs_per_spp(t):
    """The host's waits on the device inside program spans, per sample per pixel."""
    t = _spans_of(t)
    if t is None or not t.context.get("spp"):
        return None
    return t.syncs_in_spans() / t.context["spp"]
