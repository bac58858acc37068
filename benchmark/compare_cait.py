"""The numbers that decide ``correct`` in a CaiT serving cell:
``compare.py``'s ``logit_err`` and, where the mix asks for the rollout
scores, one number of the rollout in place of ``attn_err``:

  * ``keep_miss``: the share of the reference's top-``keep`` patches (the
    ones its reserve block keeps) that the program's top-``keep`` misses,
    the worst image.

CaiT's rollout runs through 24 signed maps, and its scores are peaked: a
few patches hold several times the mean. Rounding the blocks to bf16, as
the configuration's speed mode computes them, moves where those peaks
land, so ``attn_err`` (the largest score error over the largest score)
reads as high for a sound bf16 run as for a lower precision or another
image's scores: it is recorded as a reading (``controls_cait``) and not
compared. Which patches are kept moves far less: ``keep_miss`` is what
the rollout decides, and it tells a sound run from those.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import compare


def keep_miss(attn: np.ndarray, ref_attn: torch.Tensor, keep: int) -> float:
    """Worst image's share of the reference's top-``keep`` patches missing
    from the program's top-``keep``."""
    ref = ref_attn.double().cpu().numpy()
    got = np.argsort(-np.asarray(attn, np.float64), axis=1)[:, :keep]
    want = np.argsort(-ref, axis=1)[:, :keep]
    return max(1.0 - len(set(g) & set(w)) / keep for g, w in zip(got, want))


def for_config(cfg: dict, record_attn_err: bool = False) -> SimpleNamespace:
    """``compare``'s functions for a configuration (``harness.model_cfg``)
    whose last reserve block keeps ``keep`` patches: ``serve_numbers``
    gives ``logit_err`` and, where the rollout scores are given,
    ``keep_miss``, and with ``record_attn_err`` the reading ``attn_err``
    beside them."""
    keep = cfg["reserve_token_nums"][-1]

    def serve_numbers(logits, ref_logits, attn=None, ref_attn=None
                      ) -> Dict[str, float]:
        if attn is None:
            return compare.serve_numbers(logits, ref_logits)
        out = compare.serve_numbers(logits, ref_logits, attn, ref_attn)
        if not record_attn_err:
            del out["attn_err"]
        out["keep_miss"] = keep_miss(attn, ref_attn, keep)
        return out

    return SimpleNamespace(serve_numbers=serve_numbers,
                           serve_readings=compare.serve_readings)
