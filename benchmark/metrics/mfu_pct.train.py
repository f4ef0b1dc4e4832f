"""The training step's model FLOP (the benchmark's count from the batches'
shapes and active row-steps: LSTM input and recurrent products, scoring,
forward and backward, no recomputation) over the untraced passes' wall
seconds, as a share of the published dense peak of the configuration's
precision."""


def read(ctx):
    if not ctx.get("plain_s") or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["plain_s"] / ctx["peak_flops"]
