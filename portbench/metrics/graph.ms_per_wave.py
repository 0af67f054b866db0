"""graph.ms_per_wave: the ``graph`` span of ``router.execute``'s trace over
the waves it ran, in ms a wave, over the window's batches of a traced
run."""


def read(ctx):
    rows = [r for r in ctx.get("batches", [])
            if "graph_ms" in r and r["waves"] > 0]
    if not rows:
        return None
    return sum(r["graph_ms"] for r in rows) / sum(r["waves"] for r in rows)
