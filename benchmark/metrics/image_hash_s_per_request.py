"""Wall seconds inside lang.batch.warm_image_cache,
summed over the traced window, per request."""


def read(ctx):
    spans = ctx.spans.get("image_hash")
    if not spans or not ctx.requests:
        return None
    return sum(e - s for s, e in spans) / 1e9 / ctx.requests
