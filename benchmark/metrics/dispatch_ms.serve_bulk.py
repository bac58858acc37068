"""Mean host duration (ms) of the program's ``serve.dispatch`` span, one a
chunk: the wait on the chunk's copy and the enqueue of its forward."""

from benchmark.spans import host_ms, mean, named, slice_spans


def read(record):
    spans = slice_spans(record)
    return (mean(map(host_ms, named(spans, "serve.dispatch"))) if spans
            else None)
