"""Mean host time inside each ``train_step(...)`` call of the window, from
the benchmark's own span around the call (ms)."""


def read(record):
    spans = record["window"]["step_spans_s"]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
