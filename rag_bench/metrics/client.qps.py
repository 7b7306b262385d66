"""``client.qps``: the requests answered in the window over its seconds, on
the client's clock (the host-bound rate of the closed loop)."""


def read(ctx):
    return ctx["qps"] or None
