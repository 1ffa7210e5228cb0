"""Wall seconds inside lang.batch.prove_prepared,
summed over the traced window, per proof."""


def read(ctx):
    spans = ctx.spans.get("prepare")
    if not spans or not ctx.work:
        return None
    return sum(e - s for s, e in spans) / 1e9 / ctx.work
