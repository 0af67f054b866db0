"""batch_p95_ms: the 95th percentile over the window's batches of the time
from a batch's dispatch to its finish, in ms; host clock."""
import numpy as np


def read(ctx):
    lat = [r["t_finish"] - r["t_dispatch"] for r in ctx.get("batches", [])]
    if len(lat) < 20:
        return None
    return 1e3 * float(np.percentile(lat, 95))
