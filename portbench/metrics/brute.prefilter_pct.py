"""brute.prefilter_pct: the share of the traced window's brute-routed
queries that the ``filtered_topk`` kernel served filter first -- the
filter evaluated first and an exact distance computed for the passing
pairs only, in place of its TF32 screen of every pair -- in %.

The served queries are the ``prefiltered_queries`` counter of the
``search`` span under ``brute`` (``core/prefbf.py``) of the batches the
harness profiles: the ``trace_batches`` batches dispatched after the
window's second, each with an ``ft_calls`` entry where it sent queries to
the brute route.  The brute queries are those entries' counts.  A program
without the counter reads nothing."""
from portbench import spans

FIRST = 2       # the first profiled batch: the one dispatched after batch 1


def read(ctx):
    tr = ctx.get("trace")
    calls = (tr or {}).get("ft_calls")
    rows = ctx.get("batches") or []
    traces = spans.window_traces(ctx)
    if not calls or len(traces) != len(rows):
        return None
    last = min(len(rows), FIRST + ctx["traffic"]["trace_batches"])
    profiled = [j for j in range(FIRST, last) if rows[j]["brute"]]
    if len(profiled) != len(calls):
        return None
    attrs = [a for j in profiled
             for a in spans.span_attrs([traces[j]], ("brute", "search"))]
    served = spans.total(attrs, "prefiltered_queries")
    queries = sum(b for b, _ in calls)
    if served is None or not queries:
        return None
    return 100.0 * served / queries
