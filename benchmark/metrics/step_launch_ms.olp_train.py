"""Mean host ms of the traced pass's eager single steps (the program's
``train.step`` spans: the steps flushed out of a window, run without a
CUDA graph), under the profiler: the host's cost of launching one step."""

from okbench.spans import durations_ns


def read(ctx):
    tr = ctx.get("trace")
    steps = [] if tr is None else durations_ns(tr, ("train.step",))
    return sum(steps) / len(steps) / 1e6 if steps else None
