"""``http.host_ms``: the HTTP (``serve``) thread's own work on the
``/retrieve`` fast path, a batch: each request's ``http.request`` event
(``serve/http.py``) gives ``parse_s``, the body read, JSON parse and
validation up to the batcher, and ``respond_s``, the response's JSON after
the answer; both summed over the window, over its batches (``retrieve.plan``
spans). None where the program records no such event."""


def read(ctx):
    spans = ctx["spans"]
    requests = [ev for ev in spans if ev["tag"] == "http.request"]
    batches = sum(1 for ev in spans if ev["tag"] == "retrieve.plan")
    if not requests or not batches:
        return None
    return 1e3 * sum(ev["parse_s"] + ev["respond_s"] for ev in requests) / batches
