"""router.dispatch_wait_ms_per_kq: the time the router's dispatch blocked
on the card -- the upload of the compiled filter programs (the ``compile``
span's ``upload_ms``) and the read of the estimated selectivities (the
``estimate`` span's ``read_ms``) -- in ms per 1,000 queries, over the
window's batches of a traced run."""
from portbench import spans


def read(ctx):
    traces = spans.window_traces(ctx)
    upload = spans.total(spans.span_attrs(traces, ("compile",)), "upload_ms")
    read_ = spans.total(spans.span_attrs(traces, ("estimate",)), "read_ms")
    if upload is None and read_ is None:
        return None
    return spans.per_kq(traces, (upload or 0.0) + (read_ or 0.0))
