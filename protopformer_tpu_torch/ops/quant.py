"""Dynamic int8 quantization for the serving path (port of
``protopformer_tpu/ops/quant.py``).

Weights per output column, activations per row, both symmetric and
dynamic:

    y = (x_q @ w_q) * s_x * s_w,   x_q = round(x / s_x), s_x = max|x| / 127

The scales are fp32 abs-maxima floored at 1e-12, the rounding is half to
even (``torch.round``, as ``jnp.round``), and the codes are clipped to
+-127. The int8 x int8 -> int32 product is ``torch._int_mm``: the JAX
package computes it outside any Pallas kernel, so it has no kernel of its
own here; the quantize passes are plain PyTorch. The parameters stay fp32,
so checkpoints, the converters and the optimizer are unchanged.

On CUDA ``torch._int_mm`` takes more than 16 rows and a contraction and
output width that are multiples of 8 (DeiT's 192/576/768 widths are); any
other shape raises with that cause, and nothing is padded. On the CPU it
takes any shape. This is an opt-in serving mode
(``BackboneConfig.quantize="int8"``): the product has no backward.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8 quantization.

    Args:
      x: (..., K) float tensor.
    Returns:
      (x_q int8 (..., K), scale fp32 (..., 1)) with x ~= x_q * scale.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 quantization of a (K, M) matrix."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def _check_cuda_shape(rows: int, k: int, m: int) -> None:
    if rows <= 16 or k % 8 or m % 8:
        raise ValueError(
            f"int8_matmul on CUDA: torch._int_mm takes more than 16 rows and "
            f"a contraction and output width that are multiples of 8; got "
            f"{rows} rows, K={k}, M={m} (nothing is padded)"
        )


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` on the int8 path with dynamic activation scales.

    Args:
      x: (..., K) activations (any float dtype).
      w: (K, M) fp32 weights (a ``Linear``'s ``weight.t()``).
    Returns:
      (..., M) in ``out_dtype``: the int32 product times the row scales,
      then the column scales, in fp32.
    """
    K, M = w.shape
    lead = x.shape[:-1]
    xq, sx = quantize_rowwise(x.reshape(-1, K))
    # the weight quantized along K as rows of its (M, K) transpose, handed
    # to the product column-major
    wq_t, sw_t = quantize_rowwise(w.t())
    if x.device.type == "cuda":
        _check_cuda_shape(xq.shape[0], K, M)
    acc = torch._int_mm(xq, wq_t.t())
    out = acc.float() * sx * sw_t.t()
    return out.reshape(*lead, M).to(out_dtype)
