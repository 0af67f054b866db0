"""router.compile_ms_per_kq: the router's filter compilation (the
``compile`` span of ``router.execute``'s trace), in ms per 1,000 queries,
over the window's batches of a traced run."""


def read(ctx):
    rows = [r for r in ctx.get("batches", []) if "compile_ms" in r]
    if not rows:
        return None
    return 1e3 * sum(r["compile_ms"] for r in rows) / sum(
        r["queries"] for r in rows)
