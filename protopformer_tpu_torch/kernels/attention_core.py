"""K1, K3, K4 and K5: fused attention kernels (port of
``protopformer_tpu/kernels/attention_core.py``).

* ``fused_attention_block_stats`` (K1): ones-policy attention in bf16 that
  also emits the head-mean map in its storage dtype, the map's discard
  threshold and its masked row sums (``csrc/attention_block_stats.cu``).
* ``fused_attention_mean_padded`` (K3): policy-masked attention with the
  identity escape that emits the raw fp32 head-mean map, pads exactly 0
  (``csrc/attention_mean.cu``).
* ``fused_attention_core`` (K4) and ``fused_attention_core_padded`` (K5):
  K3's attention followed by the rollout normalize of its map (exact
  discard, identity blend, row normalize), emitting the NORMALIZED fp32
  map (``csrc/attention_core.cu``; K4 is K5 with no pads).

Each public function dispatches on the input's device: a CUDA tensor goes
to the hand-written kernel, a CPU tensor to the plain PyTorch version
beside it (the same steps, vectorized over the batch). Any other device
raises. Forward only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from protopformer_tpu_torch.kernels import _build
from protopformer_tpu_torch.kernels.stats import (
    bisect_keys,
    masked_row_sums,
    radix_select_keys,
    threshold_from_key,
)
from protopformer_tpu_torch.ops.masking import eps_softmax
from protopformer_tpu_torch.ops.rollout import normalize_attention_map

SOFTMAX_EPS = 1e-6
_ONE_BITS = 0x3F800000  # fp32 bit pattern of 1.0, K1's static threshold bound


def _bf16_value(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.bfloat16))


def _check_qkv(name: str, qkv: torch.Tensor, num_heads: int,
               dtypes: Tuple[torch.dtype, ...]) -> Tuple[int, int, int]:
    if qkv.dtype not in dtypes:
        raise TypeError(f"{name}: qkv dtype {qkv.dtype} not in {dtypes}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"{name}: expected (B, N, 3C), got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    B, N, C3 = qkv.shape
    C = C3 // 3
    # the kernels copy head slices in 16-byte chunks and tile the head dim
    # in at most 4 tensor-core k-steps of 16
    step = 16 // qkv.element_size()
    if C % num_heads or (C // num_heads) % step or C // num_heads > 64:
        raise ValueError(f"{name}: head dim C/H = {C}/{num_heads} must be a "
                         f"multiple of {step} and at most 64")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    return B, N, C


def _scratch(lib, query: str, *args, device: torch.device):
    """Device scratch for a launcher, of the bytes its ``query`` names (None
    where 0): the long kernels' accumulators or P above 640 tokens, which
    no longer fit shared memory or registers. Sources older than these
    routes (``cli.time_long_kernels``'s parent copy) lack the query and
    need none."""
    fn = getattr(lib, query, None)
    nbytes = fn(*args) if fn is not None else 0
    if nbytes == 0:
        return None
    return torch.empty((nbytes + 3) // 4, dtype=torch.float32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


# --- K1 ---------------------------------------------------------------------

def block_stats_plain(qkv: torch.Tensor, num_heads: int, keep: int,
                      exact_discard: bool):
    """Plain PyTorch version of K1, rounding where the kernel rounds:
    bf16 logits = bf16(fp32 dot) * bf16(hd**-0.5); ``eps_softmax``'s bf16
    branch (bf16 exp, fp32 row sum + 1e-6, bf16 reciprocal multiply);
    acc += fp32(probs) * (1/H); out = fp32-accumulated probs @ v rounded
    to bf16; the threshold is the radix select of the keep-th largest key
    of the stored map, clamped to bits(1.0). The kernel sums the dots on
    tensor cores in another order, so a bf16 logit may differ by one ulp
    and move its row of the map: the kernel's map is held to this one
    within one bf16 ulp of its largest entry, its t and s to
    ``masked_map_stats`` on its own map."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    H = num_heads
    hd = C // H
    cd = qkv.dtype
    scale = torch.tensor(hd ** -0.5, dtype=cd)
    acc = torch.zeros((B, N, N), dtype=torch.float32, device=qkv.device)
    outs = []
    for h in range(H):
        q = qkv[:, :, h * hd:(h + 1) * hd].float()
        k = qkv[:, :, C + h * hd:C + (h + 1) * hd].float()
        v = qkv[:, :, 2 * C + h * hd:2 * C + (h + 1) * hd].float()
        logits = torch.matmul(q, k.transpose(1, 2)).to(cd) * scale
        probs = eps_softmax(logits, SOFTMAX_EPS)
        acc = acc + probs.float() * (1.0 / H)
        outs.append(torch.matmul(probs.float(), v).to(cd))
    fmap = acc.to(torch.float32 if exact_discard else torch.bfloat16)
    a = fmap.float()
    prefix16 = not exact_discard
    lo = radix_select_keys(bisect_keys(a, prefix16), keep,
                           16 if prefix16 else 32, 8,
                           _ONE_BITS >> 16 if prefix16 else _ONE_BITS)
    t = threshold_from_key(lo, prefix16)
    return torch.cat(outs, dim=-1), fmap, t, masked_row_sums(a, t)


def block_stats_cuda(qkv: torch.Tensor, num_heads: int, keep: int,
                     exact_discard: bool):
    """Launch ``csrc/attention_block_stats.cu`` on bf16 (B, N, 3C) qkv."""
    B, N, C = _check_qkv("attention_block_stats", qkv, num_heads,
                         (torch.bfloat16,))
    hd = C // num_heads
    lib = _build.library()
    _build.check_smem(
        "attention_block_stats",
        lib.ppf_attention_block_stats_smem_bytes(N, hd),
    )
    dev = qkv.device
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=dev)
    fmap = torch.empty(
        (B, N, N), dtype=torch.float32 if exact_discard else torch.bfloat16,
        device=dev,
    )
    t = torch.empty(B, dtype=torch.float32, device=dev)
    s = torch.empty((B, N), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, "ppf_attention_block_stats_scratch_bytes", B, N, hd,
                       device=dev)
    with _build.on_device(dev) as stream:
        code = lib.ppf_attention_block_stats(
            qkv.data_ptr(), B, N, C, num_heads, keep, int(exact_discard),
            _bf16_value(hd ** -0.5), _bf16_value(SOFTMAX_EPS / N),
            out.data_ptr(), fmap.data_ptr(), t.data_ptr(), s.data_ptr(),
            stream, _ptr(scratch),
        )
    _build.check_launch("attention_block_stats", code)
    block_stats_cuda.launches += 1
    return out, fmap, t, s


block_stats_cuda.launches = 0


def fused_attention_block_stats(
    qkv: torch.Tensor,
    num_heads: int,
    discard_ratio: float = 0.9,
    exact_discard: bool = False,
):
    """Fused ones-policy attention emitting (out, map, threshold, row sums).

    Args:
      qkv: (B, N, 3C) bf16 packed q|k|v activations.

    Returns:
      out (B, N, C) bf16 pre-projection attention output; fmap (B, N, N)
      bf16 (speed, ``exact_discard=False``) or fp32; t (B,) in the map
      dtype; s (B, N) fp32 — the lazy-rollout triple.
    """
    N = qkv.shape[1]
    E = N * N
    keep = E - int(E * discard_ratio)
    if not 0 < keep < E:
        raise ValueError("fused block kernel requires an active discard")
    if qkv.is_cuda:
        out, fmap, t, s = block_stats_cuda(qkv, num_heads, keep, exact_discard)
    elif qkv.device.type == "cpu":
        out, fmap, t, s = block_stats_plain(qkv, num_heads, keep, exact_discard)
    else:
        raise RuntimeError(
            f"fused_attention_block_stats: no kernel for device {qkv.device}"
        )
    return out, fmap, t.to(fmap.dtype), s


# --- K3 ---------------------------------------------------------------------

def mean_padded_plain(qkv: torch.Tensor, policy: torch.Tensor, num_heads: int,
                      real_n: int):
    """Plain PyTorch version of K3: fp32 logits (no rounding before the
    scale), fp32 policy softmax with the identity escape and eps/real_n,
    V rows >= real_n zeroed, probs in the compute dtype for AV, fp32
    head mean zeroed outside the real block."""
    B, NP, C3 = qkv.shape
    C = C3 // 3
    H = num_heads
    hd = C // H
    cd = qkv.dtype
    dev = qkv.device
    eye = torch.eye(NP, dtype=torch.float32, device=dev)
    idx = torch.arange(NP, device=dev)
    row_real = (idx < real_n).float()
    real_block = row_real[:, None] * row_real[None, :]
    pol = policy.float()[:, None, :]
    attn_policy = pol + (1.0 - pol) * eye
    acc = torch.zeros((B, NP, NP), dtype=torch.float32, device=dev)
    outs = []
    for h in range(H):
        q = qkv[:, :, h * hd:(h + 1) * hd].float()
        k = qkv[:, :, C + h * hd:C + (h + 1) * hd].float()
        v = qkv[:, :, 2 * C + h * hd:2 * C + (h + 1) * hd].float()
        v = v * row_real[:, None]
        logits = torch.matmul(q, k.transpose(1, 2)) * (hd ** -0.5)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m) * attn_policy
        probs = (e + SOFTMAX_EPS / real_n) / (
            e.sum(dim=-1, keepdim=True) + SOFTMAX_EPS
        )
        acc = acc + probs * (1.0 / H)
        outs.append(torch.matmul(probs.to(cd).float(), v).to(cd))
    return torch.cat(outs, dim=-1), acc * real_block


def mean_padded_cuda(qkv: torch.Tensor, policy: torch.Tensor, num_heads: int,
                     real_n: int):
    """Launch ``csrc/attention_mean.cu``."""
    B, NP, C = _check_qkv("attention_mean", qkv, num_heads,
                          (torch.float32, torch.bfloat16))
    if policy.shape != (B, NP) or policy.device != qkv.device:
        raise ValueError(
            f"attention_mean: policy must be ({B}, {NP}) on {qkv.device}"
        )
    if not 0 < real_n <= NP:
        raise ValueError(f"attention_mean: real_n={real_n} not in (0, {NP}]")
    pol = policy.float().contiguous()
    is_bf16 = qkv.dtype == torch.bfloat16
    lib = _build.library()
    _build.check_smem(
        "attention_mean",
        lib.ppf_attention_mean_smem_bytes(NP, C // num_heads, int(is_bf16)),
    )
    dev = qkv.device
    out = torch.empty((B, NP, C), dtype=qkv.dtype, device=dev)
    fmap = torch.empty((B, NP, NP), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, "ppf_attention_mean_scratch_bytes", B, NP,
                       C // num_heads, int(is_bf16), device=dev)
    with _build.on_device(dev) as stream:
        code = lib.ppf_attention_mean(
            qkv.data_ptr(), pol.data_ptr(), B, NP, C, num_heads, real_n,
            int(is_bf16), (C // num_heads) ** -0.5, SOFTMAX_EPS / real_n,
            out.data_ptr(), fmap.data_ptr(),
            stream, _ptr(scratch),
        )
    _build.check_launch("attention_mean", code)
    mean_padded_cuda.launches += 1
    return out, fmap


mean_padded_cuda.launches = 0


def fused_attention_mean_padded(
    qkv: torch.Tensor,
    policy: torch.Tensor,
    num_heads: int,
    real_n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention emitting (out, raw head-mean fp32 map).

    Args:
      qkv: (B, NP, 3C) activations in the compute dtype (fp32 or bf16);
        rows >= real_n are pads.
      policy: (B, NP) keep-mask, pads 0.
      real_n: the real token count; eps terms use it.

    Returns:
      (out (B, NP, C) in the qkv dtype, fmap (B, NP, NP) fp32 with every
      entry outside the real (real_n, real_n) block exactly 0).
    """
    if qkv.is_cuda:
        return mean_padded_cuda(qkv, policy, num_heads, real_n)
    if qkv.device.type == "cpu":
        return mean_padded_plain(qkv, policy, num_heads, real_n)
    raise RuntimeError(
        f"fused_attention_mean_padded: no kernel for device {qkv.device}"
    )


# --- K4 and K5 ----------------------------------------------------------------
#
# The JAX functions' ``block_batch`` (samples per grid step) and
# ``interpret`` were TPU tiling and debugging choices: a CUDA block takes
# one sample (or one row tile of one), and the CPU runs the plain versions.
# Neither is carried over. The compute dtype is the qkv dtype, as for K3.

def core_padded_plain(qkv: torch.Tensor, policy: torch.Tensor,
                      num_heads: int, real_n: int, discard_ratio: float = 0.9,
                      identity_weight: float = 0.2):
    """Plain PyTorch version of K5: K3's plain attention, then
    ``normalize_attention_map`` (exact discard) of the real (real_n, real_n)
    block of its map, padded back to NP with zeros."""
    out, raw = mean_padded_plain(qkv, policy, num_heads, real_n)
    norm = normalize_attention_map(raw[:, :real_n, :real_n], discard_ratio,
                                   identity_weight, exact_discard=True)
    pad = qkv.shape[1] - real_n
    return out, torch.nn.functional.pad(norm, (0, pad, 0, pad))


def core_plain(qkv: torch.Tensor, policy, num_heads: int,
               discard_ratio: float = 0.9, identity_weight: float = 0.2):
    """Plain PyTorch version of K4: K5's with no pads; ``policy`` None is
    the all-ones policy."""
    B, N, _ = qkv.shape
    if policy is None:
        policy = torch.ones((B, N), dtype=torch.float32, device=qkv.device)
    return core_padded_plain(qkv, policy, num_heads, N, discard_ratio,
                             identity_weight)


def _core_launch(name: str, qkv: torch.Tensor, policy, num_heads: int,
                 real_n: int, discard_ratio: float, identity_weight: float):
    """Launch ``csrc/attention_core.cu``; ``policy`` None is all ones."""
    B, NP, C = _check_qkv(name, qkv, num_heads,
                          (torch.float32, torch.bfloat16))
    if policy is not None and (policy.shape != (B, NP)
                               or policy.device != qkv.device):
        raise ValueError(f"{name}: policy must be ({B}, {NP}) on {qkv.device}")
    if not 0 < real_n <= NP:
        raise ValueError(f"{name}: real_n={real_n} not in (0, {NP}]")
    pol = None if policy is None else policy.float().contiguous()
    is_bf16 = qkv.dtype == torch.bfloat16
    hd = C // num_heads
    lib = _build.library()
    _build.check_smem(name, lib.ppf_attention_mean_smem_bytes(NP, hd,
                                                              int(is_bf16)))
    E = real_n * real_n
    keep = E - int(E * discard_ratio)
    dev = qkv.device
    out = torch.empty((B, NP, C), dtype=qkv.dtype, device=dev)
    fmap = torch.empty((B, NP, NP), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, "ppf_attention_mean_scratch_bytes", B, NP, hd,
                       int(is_bf16), device=dev)
    with _build.on_device(dev) as stream:
        code = lib.ppf_attention_core(
            qkv.data_ptr(), _ptr(pol), B, NP, C,
            num_heads, real_n, keep, int(is_bf16),
            hd ** -0.5, SOFTMAX_EPS / real_n, identity_weight,
            1.0 + identity_weight, out.data_ptr(), fmap.data_ptr(),
            stream, _ptr(scratch),
        )
    _build.check_launch(name, code)
    return out, fmap


def core_cuda(qkv: torch.Tensor, policy, num_heads: int,
              discard_ratio: float = 0.9, identity_weight: float = 0.2):
    """Launch K4 (``csrc/attention_core.cu`` with NP = N); ``policy`` None
    is the all-ones policy."""
    out, fmap = _core_launch("attention_core", qkv, policy, num_heads,
                             qkv.shape[1], discard_ratio, identity_weight)
    core_cuda.launches += 1
    return out, fmap


core_cuda.launches = 0


def core_padded_cuda(qkv: torch.Tensor, policy: torch.Tensor, num_heads: int,
                     real_n: int, discard_ratio: float = 0.9,
                     identity_weight: float = 0.2):
    """Launch K5 (``csrc/attention_core.cu``)."""
    out, fmap = _core_launch("attention_core_padded", qkv, policy, num_heads,
                             real_n, discard_ratio, identity_weight)
    core_padded_cuda.launches += 1
    return out, fmap


core_padded_cuda.launches = 0


def fused_attention_core(
    qkv: torch.Tensor,
    policy,
    num_heads: int,
    discard_ratio: float = 0.9,
    identity_weight: float = 0.2,
    ones_policy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused softmax attention + rollout-map normalization.

    Args:
      qkv: (B, N, 3C) q|k|v activations in the compute dtype (fp32 or
        bf16).
      policy: (B, N) keep-mask, or None (all ones).
      ones_policy: the all-ones policy whatever ``policy`` holds
        (pre-prune blocks).

    Returns:
      (out (B, N, C) pre-projection in the qkv dtype, the normalized
      rollout map (B, N, N) fp32).
    """
    args = (qkv, None if ones_policy else policy, num_heads, discard_ratio,
            identity_weight)
    if qkv.is_cuda:
        return core_cuda(*args)
    if qkv.device.type == "cpu":
        return core_plain(*args)
    raise RuntimeError(f"fused_attention_core: no kernel for device {qkv.device}")


def fused_attention_core_padded(
    qkv: torch.Tensor,
    policy: torch.Tensor,
    num_heads: int,
    real_n: int,
    discard_ratio: float = 0.9,
    identity_weight: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_attention_core`` over pre-padded operands.

    Args:
      qkv: (B, NP, 3C) activations; rows >= real_n are pads.
      policy: (B, NP) keep-mask with pads 0.
      real_n: the real token count (<= NP); the eps terms and the discard
        keep count use it, so the real block matches the unpadded kernel.

    Returns:
      (out (B, NP, C) in the qkv dtype, the normalized map (B, NP, NP)
      fp32, every pad row and pad column exactly 0).
    """
    args = (qkv, policy, num_heads, real_n, discard_ratio, identity_weight)
    if qkv.is_cuda:
        return core_padded_cuda(*args)
    if qkv.device.type == "cpu":
        return core_padded_plain(*args)
    raise RuntimeError(
        f"fused_attention_core_padded: no kernel for device {qkv.device}"
    )
