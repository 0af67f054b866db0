"""pq_adc_topr_roofline: the data-sheet bound of the traced window's
``pq_adc_topr`` calls (the compressed brute route's scan) over their
device time, in %.

The work of a call is ``roofline.pq_adc_topr_work`` for its brute
sub-batch over the N code rows, at the configuration's ``quant`` widths
and re-rank depth R = max(k, rerank x k), with the pairs the queries'
filters pass counted by the reference's own filter evaluation
(``pq_calls``).  The time is the profiler's for the kernels the call
launches: ``pq_screen`` and ``merge_splits``."""
from portbench import data, roofline

KERNELS = ("pq_screen", "merge_splits")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    t = sum(s for name, s in tr["device_s"].items()
            if any(k in name for k in KERNELS))
    calls = tr.get("pq_calls", [])
    if t <= 0 or not calls:
        return None
    cfg = ctx["cfg"]
    q, k = cfg["quant"], cfg["search"]["k"]
    icols, fcols = data.schema_columns(cfg)
    bound = 0.0
    for b, passing in calls:
        ops, nbytes = roofline.pq_adc_topr_work(
            b, cfg["n"], q["m"], 1 << q["nbits"], len(icols), len(fcols),
            max(k, q["rerank"] * k), passing)
        bound += roofline.bound_s(ops, nbytes)
    return 100.0 * bound / t
