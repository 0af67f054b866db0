"""router.finish_wait_ms_per_kq: the time the deferred finish blocked in
its copies of the batch's answers to the host (the trace's
``finish_wait_ms``: the device work still queued ahead of them), in ms per
1,000 queries, over the window's batches of a traced run."""
from portbench import spans


def read(ctx):
    traces = spans.window_traces(ctx)
    wait = spans.total([t["attrs"] for t in traces], "finish_wait_ms")
    if wait is None:
        return None
    return spans.per_kq(traces, wait)
