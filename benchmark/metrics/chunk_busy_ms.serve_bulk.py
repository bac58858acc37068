"""Device-busy time of the traced slice for each served chunk (ms)."""


def read(record):
    s = record["slice"]
    if not s["chunks"] or not s["busy_s"]:
        return None
    return 1e3 * s["busy_s"] / s["chunks"]
