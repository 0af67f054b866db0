"""qps: the queries of every batch finished in the window over the window's
seconds (from the first dispatch to the last finish); host clock."""


def read(ctx):
    if not ctx.get("batches") or ctx["window_s"] <= 0:
        return None
    return ctx["queries"] / ctx["window_s"]
