"""What the per-layer readers share: the hand-written kernels' names, and
sums over a traced stretch (``harness/profile.TraceData``)."""

from __future__ import annotations

# every kernel the program's CUDA sources define (``__global__``), by name
HAND_KERNELS = (
    "bounce_bwd_kernel", "bounce_kernel", "bounce_kernel_grouped", "bounce_merge_kernel",
    "lane_order_keys", "lane_order_place", "mesh_min_kernel", "mesh_nearest_kernel",
    "nearest_kernel", "occlusion_kernel", "row_sum_segments", "trace_bwd_kernel",
    "trace_fwd_kernel", "trace_fwd_kernel_packed", "trace_kernel", "winner_kernel",
)
HAND_PATTERN = "|".join(HAND_KERNELS)
# the forward trace (kernel 1, every instance)
TRACE_PATTERN = "trace_kernel"
# the differentiable trace: forward with residuals (kernel 4), reverse loop
# (kernel 5), its table row sums and its media instance's lane order
TRACE_GRAD_PATTERN = ("trace_fwd_kernel|trace_fwd_kernel_packed|trace_bwd_kernel|"
                      "row_sum_segments|lane_order_keys|lane_order_place")


def other_device_ms_per_spp(t):
    """Device ms per sample per pixel of every kernel that is not a hand kernel."""
    spp = t.context["spp"]
    if not spp or not t.kernels:
        return None
    total = sum(e - s for s, e, _ in t.kernels)
    hand, _ = t.kernel_seconds(HAND_PATTERN)
    return (total - hand) * 1e3 / spp


def launches_per_spp(t):
    spp = t.context["spp"]
    return len(t.kernels) / spp if spp and t.kernels else None


def idle_pct(t):
    """The device's idle share at the host's untraced pace: one less the
    traced stretch's busy time over the length of an untraced stretch of as
    many units (the profiler's cost per launch lengthens the traced one)."""
    if not t.device_ops or not t.untraced_window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.untraced_window_s)


def roofline_pct(t, pattern: str, bound_s):
    """``100 * least time / measured device time`` of the kernels matching
    ``pattern``; None where the stretch ran none."""
    seconds, launches = t.kernel_seconds(pattern)
    if not launches or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds
