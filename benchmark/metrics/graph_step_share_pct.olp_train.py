"""Share of the window's training steps that ran inside a CUDA-graph replay
(``Trainer.step_log`` ``window`` of ``replay``, or ``capture``: captured,
then replayed).  Read only where the trainer runs multi-step windows."""


def read(ctx):
    kinds = ctx.get("window_kinds")
    if not kinds or ctx.get("scan_steps", 1) <= 1:
        return None
    return 100.0 * sum(k in ("replay", "capture") for k in kinds) / len(kinds)
