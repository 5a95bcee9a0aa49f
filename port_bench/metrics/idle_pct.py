"""The share of an untraced stretch in which no operation would run on the device,
in %: the device-only trace's busy time over the untraced stretch's length."""

from port_bench.harness.readers import idle_pct


def value(t):
    return idle_pct(t)
