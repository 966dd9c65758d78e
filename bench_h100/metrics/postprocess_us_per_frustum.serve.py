"""Serving driver: host microseconds in ``serve.postprocess`` (the batched
host postprocess, by the span's own clock) per frustum streamed, over the
window's calls that ran without the profiler. Nothing is read where the
calls carry no such span."""


def read(ctx):
    calls = [c for c in ctx.get("calls") or () if not c["profiled"]
             and "serve.postprocess" in c["spans"]]
    frustums = sum(c["frustums"] for c in calls)
    if ctx["job"] != "serve" or not frustums:
        return None
    return 1e6 * sum(c["spans"]["serve.postprocess"]["s"] for c in calls) / frustums
