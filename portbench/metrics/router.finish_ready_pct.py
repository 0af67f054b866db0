"""router.finish_ready_pct: the share of the window's traced batches whose
deferred finish found the copies of its answers already on the host -- the
trace's ``finish_ready``, 1 when the event recorded behind those copies at
dispatch had completed as the finish began, 0 when the finish had to wait
-- in %.  A program without the attribute reads nothing."""
from portbench import spans


def read(ctx):
    traces = spans.window_traces(ctx)
    ready = [t["attrs"]["finish_ready"] for t in traces
             if "finish_ready" in t["attrs"]]
    if not ready:
        return None
    return 100.0 * sum(ready) / len(traces)
