"""brute.pq_rescored_pct: the share of the filter-passing pairs of the
traced window's compressed brute calls whose exact ADC key the
``pq_adc_topr`` kernel computed, in %: the passing pairs its 8-bit screen
could not settle.

The re-scored pairs are the ``rescored_pairs`` counter of the ``screen``
span under ``brute``/``search`` (``quant/adc.py``) of the batches the
harness profiles: the ``trace_batches`` batches dispatched after the
window's second, each with a ``pq_calls`` entry where it sent queries to
the brute route.  The passing pairs are those calls' count by the
reference's own filter evaluation.  A program without the counter reads
nothing."""
from portbench import spans

FIRST = 2       # the first profiled batch: the one dispatched after batch 1


def read(ctx):
    tr = ctx.get("trace")
    calls = (tr or {}).get("pq_calls")
    rows = ctx.get("batches") or []
    traces = spans.window_traces(ctx)
    if not calls or len(traces) != len(rows):
        return None
    last = min(len(rows), FIRST + ctx["traffic"]["trace_batches"])
    profiled = [j for j in range(FIRST, last) if rows[j]["brute"]]
    if len(profiled) != len(calls):
        return None
    attrs = [a for j in profiled
             for a in spans.span_attrs([traces[j]],
                                       ("brute", "search", "screen"))]
    rescored = spans.total(attrs, "rescored_pairs")
    passing = sum(p for _, p in calls)
    if rescored is None or not passing:
        return None
    return 100.0 * rescored / passing
