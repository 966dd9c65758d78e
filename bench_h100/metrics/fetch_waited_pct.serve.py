"""Serving driver: the groups whose fetch found the card not yet done with
them (``fetch_waited``), as a share of the groups fetched (``serve.fetch``
entries), over the window's calls that ran without the profiler. A
diagnostic of which side sets the pace, not a cost: 100 means the card
did, and a faster card side (the rate up) can lower it as well as a slower
host. Nothing is read where the calls carry no such counter or span."""


def read(ctx):
    calls = [c for c in ctx.get("calls") or () if not c["profiled"]
             and "serve.fetch" in c["spans"] and c.get("fetch_waited") is not None]
    groups = sum(c["spans"]["serve.fetch"]["n"] for c in calls)
    if ctx["job"] != "serve" or not groups:
        return None
    return 100.0 * sum(c["fetch_waited"] for c in calls) / groups
