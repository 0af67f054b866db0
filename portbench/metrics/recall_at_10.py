"""recall_at_10: mean recall@10 of the window's answers that the reference
checked (a sample drawn from the seed across all batches), against the
exact filtered top-10."""


def read(ctx):
    return ctx["recall"] if ctx.get("batches") else None
