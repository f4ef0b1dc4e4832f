"""The served requests' model FLOP (the benchmark's count: each distinct
query entity and relation through the LSTM, every query scored against
every entity, forward only) over the untraced requests' summed latency, as
a share of the published dense peak of the configuration's precision."""


def read(ctx):
    if not ctx.get("serve_s") or not ctx.get("serve_flops"):
        return None
    return 100.0 * ctx["serve_flops"] / ctx["serve_s"] / ctx["peak_flops"]
