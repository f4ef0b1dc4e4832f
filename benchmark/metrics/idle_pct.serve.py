"""Share of the traced requests' wall time in which no operation ran on the
device (the union of the profiler's device intervals is empty)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.wall_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
