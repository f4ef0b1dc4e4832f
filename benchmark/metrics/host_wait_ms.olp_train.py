"""Host ms a training step waits for its planned batch (``Trainer.step_log``
``wait_ms``; a window's wait falls on its first step), summed over the
window's untraced steps and divided by those steps."""


def read(ctx):
    waits = ctx.get("wait_ms")
    if not waits:
        return None
    return sum(waits) / len(waits)
