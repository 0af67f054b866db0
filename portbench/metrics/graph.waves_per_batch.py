"""graph.waves_per_batch: the waves of the graph route's traversal a batch
(``SearchResult.waves``), averaged over the window's batches that had
graph-routed queries."""


def read(ctx):
    rows = [r["waves"] for r in ctx.get("batches", []) if r["waves"] > 0]
    if not rows:
        return None
    return sum(rows) / len(rows)
