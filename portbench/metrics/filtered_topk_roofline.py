"""filtered_topk_roofline: the data-sheet bound of the traced
window's ``filtered_topk`` calls over their device time, in %.

The work of a call is ``roofline.filtered_topk_work`` for its brute
sub-batch (``SearchResult.routed_brute``) over the N rows, with the pairs
the queries' filters pass, counted by the reference's own filter
evaluation.  The time is the profiler's for the kernels ``ft_screen`` and
``merge_splits``."""
from portbench import data, roofline

KERNELS = ("ft_screen", "merge_splits")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    t = sum(s for name, s in tr["device_s"].items()
            if any(k in name for k in KERNELS))
    calls = tr.get("ft_calls", [])
    if t <= 0 or not calls:
        return None
    cfg = ctx["cfg"]
    icols, fcols = data.schema_columns(cfg)
    bound = 0.0
    for b, passing in calls:
        flops, nbytes = roofline.filtered_topk_work(
            b, cfg["n"], cfg["dim"], len(icols), len(fcols),
            cfg["search"]["k"], passing)
        bound += roofline.bound_s(flops, nbytes)
    return 100.0 * bound / t
