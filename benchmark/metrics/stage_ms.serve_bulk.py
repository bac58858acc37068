"""Mean duration (ms, host clock) of the program's ``serve.stage`` span,
one a chunk: the wait for the pinned slot, the copy into it, the pad's
zero and the device copy's enqueue."""

from benchmark.spans import host_ms, mean, named, slice_spans


def read(record):
    spans = slice_spans(record)
    return mean(map(host_ms, named(spans, "serve.stage"))) if spans else None
