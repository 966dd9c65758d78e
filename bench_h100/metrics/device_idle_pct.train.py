"""The device in the traced stretch of a train run: the share of the
stretch's host-clock length in which no kernel, copy or set ran on it."""


def read(ctx):
    summary = ctx.get("trace")
    if ctx["job"] != "train" or summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
