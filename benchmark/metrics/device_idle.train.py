"""Share of the traced slice with no operation running on the device (%)."""

from benchmark.readers import device_idle


def read(record):
    return device_idle(record)
