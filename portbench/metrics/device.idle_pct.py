"""device.idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the card (``torch.profiler`` timeline), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
