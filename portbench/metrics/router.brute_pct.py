"""router.brute_pct: the share of the window's queries that the selector
sent to the brute route (``SearchResult.routed_brute``), in %."""


def read(ctx):
    rows = ctx.get("batches", [])
    if not rows:
        return None
    return 100.0 * sum(r["brute"] for r in rows) / sum(r["queries"]
                                                       for r in rows)
