"""setup_s: seconds from the process's start to the end of the warm-up
(data, graph, the port's index, one warm-up batch); host clock."""


def read(ctx):
    return ctx["setup_s"] if ctx.get("batches") else None
