"""graph.sync_ms_per_wave: the time the host blocked in the graph
traversal's once-a-wave sync (the router's ``search`` span under ``graph``:
``sync_ms`` over ``waves``), in ms a wave, over the window's batches of a
traced run.  The rest of a wave's time (``graph.ms_per_wave``) is the host
issuing the wave's ops."""
from portbench import spans


def read(ctx):
    attrs = spans.span_attrs(spans.window_traces(ctx), ("graph", "search"))
    sync, waves = spans.total(attrs, "sync_ms"), spans.total(attrs, "waves")
    if sync is None or not waves:
        return None
    return sync / waves
