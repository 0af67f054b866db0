"""graph.lane_active_pct: the share of the graph traversal's launched lanes
that were still searching (the router's ``search`` span under ``graph``:
``lanes_active`` over ``lanes_launched``, each summed over waves), in %,
over the window's batches of a traced run."""
from portbench import spans


def read(ctx):
    attrs = spans.span_attrs(spans.window_traces(ctx), ("graph", "search"))
    active = spans.total(attrs, "lanes_active")
    launched = spans.total(attrs, "lanes_launched")
    if active is None or not launched:
        return None
    return 100.0 * active / launched
