"""Share of the traced pass's wall time in which no operation ran on the
device while the training thread waited for its next planned batch or
window (the program's ``train.wait_batch`` span): the overlap of the
device's idle intervals with that span, over the pass's wall time."""

from okbench.spans import idle_within_s


def read(ctx):
    tr = ctx.get("trace")
    idle = None if tr is None or tr.wall_s <= 0 else idle_within_s(tr, ("train.wait_batch",))
    return None if idle is None else 100.0 * idle / tr.wall_s
