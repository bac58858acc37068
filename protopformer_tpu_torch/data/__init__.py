"""Input preprocessing (port of ``protopformer_tpu/data/preprocess.py``)."""
