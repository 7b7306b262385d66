"""``batcher.batch_size``: requests a micro-batch, from the batcher's
``retrieve.batched size=N`` log records in the window (a batch of one
logs none)."""


def read(ctx):
    sizes = ctx["batch_sizes"]
    return sum(sizes) / len(sizes) if sizes else None
