"""graph.useful_ids_pct: the share of the neighbour ids handed to the
graph traversal's scorer that were valid and not yet visited (the router's
``search`` span under ``graph``: ``ids_useful`` over ``ids_launched``, the
stage width x M0 summed over waves), in %, over the window's batches of a
traced run."""
from portbench import spans


def read(ctx):
    attrs = spans.span_attrs(spans.window_traces(ctx), ("graph", "search"))
    useful = spans.total(attrs, "ids_useful")
    launched = spans.total(attrs, "ids_launched")
    if useful is None or not launched:
        return None
    return 100.0 * useful / launched
