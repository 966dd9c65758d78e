"""Serving driver: batches re-run through the full decode because their
foreground sections overflowed the compaction's cap, per 1000 frustums
streamed in the window (``run_test``'s ``overflow_reruns`` over its
``frustums``)."""


def read(ctx):
    if ctx["job"] != "serve" or not ctx["frustums"]:
        return None
    return 1000.0 * ctx["overflow_reruns"] / ctx["frustums"]
