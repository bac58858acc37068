"""Mean, per request of the traced slice, of the ms from the program's
``serve.request`` span's start to the start of its first ``serve.dispatch``
span: the staging that runs before the device gets its first forward."""

from benchmark.spans import lead_ins_ms, mean, slice_spans


def read(record):
    spans = slice_spans(record)
    return mean(lead_ins_ms(spans)) if spans else None
