"""Serving engine: fixed-batch PPNet inference over raw uint8 images (port
of ``protopformer_tpu/serving.py``).

  * the ImageNet normalization and the uint8 /255 are folded into the
    patch-embed conv (``data/preprocess.py``): the engine consumes raw
    (N, H, W, 3) uint8 RGB;
  * a request of any size is cut into chunks of ``batch_size``, the tail
    chunk zero-padded, and the padding rows dropped once at the end;
  * at most ``stage_window`` input chunks are staged at once. On CUDA each
    chunk goes through a pinned host buffer and a ``non_blocking`` copy on
    a copy stream, so host-to-device copies overlap the forwards;
  * ``push_forward`` runs ``PPNet.push_forward`` (the interpretability
    tools' forward) over the same chunks.

Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``; with
no CUDA device the default raises instead of falling back. An fp32 engine
runs its forwards with TF32 off (cuDNN and matmul) so parity mode is true
fp32, and leaves the process-wide settings as it found them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from protopformer_tpu_torch.core.config import BackboneConfig, PPNetConfig
from protopformer_tpu_torch.core.device import resolve_device
from protopformer_tpu_torch.data.preprocess import (
    fold_normalization_into_patch_embed,
)
from protopformer_tpu_torch.models.ppnet import construct_ppnet


class ServingResult(NamedTuple):
    logits: np.ndarray  # (N, num_classes) fp32
    top_class: np.ndarray  # (N,) int32 argmax
    cls_token_attn: Optional[np.ndarray]  # (N, P) rollout foreground scores


class PushResult(NamedTuple):
    cls_token_attn: np.ndarray  # (N, P) rollout foreground scores
    proto_acts: np.ndarray  # (N, num_prototypes, k, k) fp32 activations


@contextlib.contextmanager
def no_tf32():
    """Run the enclosed CUDA work in true fp32: cuDNN convolutions and
    matmuls without TF32. The process-wide settings are restored on exit."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(precision)


def model_precision(model: torch.nn.Module, device: torch.device):
    """``no_tf32()`` for an fp32 model on CUDA, else a null context: an fp32
    forward on the card is true fp32 (cuDNN's TF32 is on by default and
    would round the patch-embed conv)."""
    fp32 = getattr(model, "compute_dtype", torch.float32) == torch.float32
    return no_tf32() if fp32 and device.type == "cuda" \
        else contextlib.nullcontext()


class ServingEngine:
    """Fixed-batch PPNet inference over raw uint8 images.

    Args:
      backbone / ppnet: model configuration.
      state_dict: trained weights in the reference layout (fp32); the
        normalization fold is applied here — pass the plain weights.
      batch_size: the fixed chunk (160 by default).
      compute_dtype: torch.bfloat16 (speed) or torch.float32 (parity).
      with_attn: also return the CLS rollout scores per image.
      stage_window: input chunks staged ahead of compute at most.
      device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        backbone: BackboneConfig,
        ppnet: PPNetConfig,
        state_dict,
        batch_size: int = 160,
        compute_dtype: torch.dtype = torch.bfloat16,
        with_attn: bool = False,
        stage_window: int = 4,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.with_attn = with_attn
        self.stage_window = max(1, stage_window)
        self._img_size = backbone.img_size
        model = construct_ppnet(backbone, ppnet, compute_dtype)
        model.load_state_dict(
            fold_normalization_into_patch_embed(
                state_dict, input_scale=1.0 / 255.0
            ),
            strict=True,
        )
        self.model = model.to(self.device).eval()
        cuda = self.device.type == "cuda"
        shape = (batch_size, self._img_size, self._img_size, 3)
        self._host = [torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
                      for _ in range(self.stage_window)]
        self._host_free: List[Optional[torch.cuda.Event]] = [None] * len(self._host)
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._next_slot = 0
        self.last_peak_staged = 0

    def _forward(self, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), model_precision(self.model, self.device):
            out = self.model(chunk)
        ret = {"logits": out.logits.float()}
        if self.with_attn:
            ret["cls_token_attn"] = out.cls_token_attn
        return ret

    def _stage_chunk(self, images: np.ndarray, start: int):
        """Copy the chunk at ``start`` (zero-padded) into the next pinned
        buffer and start its device copy; returns (device chunk, ready event
        or None)."""
        chunk = images[start:start + self.batch_size]
        real = chunk.shape[0]
        slot = self._next_slot
        self._next_slot = (slot + 1) % len(self._host)
        if self._host_free[slot] is not None:
            self._host_free[slot].synchronize()  # its last copy has finished
        host = self._host[slot]
        host[:real].copy_(torch.from_numpy(chunk))
        host[real:].zero_()
        if self._copy_stream is None:
            return host.clone(), None
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self._host_free[slot] = ready
        return dev, ready

    def _push(self, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
        with model_precision(self.model, self.device):
            out = self.model.push_forward(chunk)
        return {"cls_token_attn": out.cls_token_attn,
                "proto_acts": out.proto_acts}

    def _consume(self, staged, forward) -> Dict[str, torch.Tensor]:
        dev, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            dev.record_stream(stream)
        return forward(dev)

    def warmup(self) -> None:
        """Run one forward on a dummy chunk and wait for it."""
        dummy = torch.zeros(
            (self.batch_size, self._img_size, self._img_size, 3),
            dtype=torch.uint8, device=self.device,
        )
        self._forward(dummy)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def throughput_probe(self, n_images: int = 10240, reps: int = 3) -> dict:
        """Sustained serving rate (img/s) of an n-image request with its
        chunks already on the device: per-chunk forwards, the concatenation
        and one tail slice, ending in a device synchronize.

        Returns {"img_per_sec", "best_img_per_sec", "n_images", "chunks"}.
        """
        rng = np.random.default_rng(0)
        shape = (self.batch_size, self._img_size, self._img_size, 3)
        chunks = [
            torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(
                self.device
            )
            for _ in range(0, n_images, self.batch_size)
        ]
        self.warmup()

        def run_once() -> float:
            t0 = time.perf_counter()
            logits = [self._forward(c)["logits"] for c in chunks]
            torch.cat(logits)[:n_images]
            self._sync()
            return time.perf_counter() - t0

        dts = [run_once() for _ in range(reps)]
        return {
            "img_per_sec": n_images * len(dts) / sum(dts),
            "best_img_per_sec": n_images / min(dts),
            "n_images": n_images,
            "chunks": len(chunks),
        }

    def _run(self, images: np.ndarray, forward) -> Dict[str, np.ndarray]:
        """``forward`` over (N, H, W, 3) uint8 RGB, chunk by chunk with
        ``stage_window`` chunks staged ahead; each output concatenated over
        the chunks, cut to N rows and fetched as fp32 numpy."""
        images = np.asarray(images)
        if images.dtype != np.uint8:
            raise ValueError(
                f"ServingEngine consumes raw uint8 RGB, got {images.dtype}"
            )
        n = images.shape[0]
        starts = list(range(0, n, self.batch_size))
        staged = [self._stage_chunk(images, s)
                  for s in starts[: self.stage_window]]
        self.last_peak_staged = min(len(starts), self.stage_window)
        outs: Dict[str, List[torch.Tensor]] = {}
        for i in range(len(starts)):
            out = self._consume(staged[i], forward)
            staged[i] = None  # the chunk's input is consumed
            for key, value in out.items():
                outs.setdefault(key, []).append(value)
            nxt = i + self.stage_window
            if nxt < len(starts):
                staged.append(self._stage_chunk(images, starts[nxt]))
            self.last_peak_staged = max(
                self.last_peak_staged,
                sum(1 for s in staged if s is not None),
            )
        return {key: torch.cat(chunks)[:n].float().cpu().numpy()
                for key, chunks in outs.items()}

    def __call__(self, images: np.ndarray) -> ServingResult:
        """Inference on (N, H, W, 3) uint8 RGB, any N >= 1."""
        out = self._run(images, self._forward)
        logits = out["logits"]
        return ServingResult(
            logits=logits,
            top_class=np.argmax(logits, axis=-1).astype(np.int32),
            cls_token_attn=out.get("cls_token_attn"),
        )

    def push_forward(self, images: np.ndarray) -> PushResult:
        """``PPNet.push_forward`` (the interpretability tools' forward) on
        (N, H, W, 3) uint8 RGB, any N >= 1, chunked as ``__call__``."""
        out = self._run(images, self._push)
        return PushResult(cls_token_attn=out["cls_token_attn"],
                          proto_acts=out["proto_acts"])
