"""gather_distance_roofline: the data-sheet bound of the traced graph
traversals' ``gather_distance`` work over the kernel's device time, in %.

The work is ``roofline.traversal_gather_work`` over the rows the traced
batch's expansions score: each expansion (``SearchResult.hops``, summed
over the batch's graph-routed queries) scores one node's M0 neighbours.
That counts what the traversal needs, not the (B, M) blocks a design
launches; it still counts a neighbour already visited, or a -1 slot of a
short list, as a row, so the share is an upper figure.  The time is the
profiler's for the kernel ``gd_kernel``."""
from portbench import data, roofline

KERNELS = ("gd_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    t = sum(s for name, s in tr["device_s"].items()
            if any(k in name for k in KERNELS))
    calls = tr.get("gd_calls", [])
    if t <= 0 or not calls:
        return None
    cfg = ctx["cfg"]
    icols, fcols = data.schema_columns(cfg)
    m0 = cfg["hnsw"]["M0"]
    bound = 0.0
    for b, hops in calls:
        flops, nbytes = roofline.traversal_gather_work(
            b, hops * m0, cfg["dim"], len(icols), len(fcols))
        bound += roofline.bound_s(flops, nbytes)
    return 100.0 * bound / t
