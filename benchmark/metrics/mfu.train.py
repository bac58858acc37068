"""A train step's operations (``counts.train_flops``, three times the train
forward's) for every image of the window's steps, over the window, as a
share of the card's bf16 peak (%)."""

from benchmark import counts
from benchmark.readers import mfu


def read(record):
    return mfu(record, "train", counts.train_flops)
