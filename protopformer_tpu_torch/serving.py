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
    tools' forward) over the same chunks;
  * with ``mesh=`` (``parallel/mesh.py``) one replica a device serves its
    contiguous slice of each chunk, as the JAX engine shards a chunk on
    its mesh's data axis.

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
from protopformer_tpu_torch.parallel.mesh import replicate


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


class _Lane:
    """One replica of the model on its device, with its own pinned staging
    buffers and copy stream."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 rows: int, img_size: int, stage_window: int):
        self.model = model
        self.device = device
        cuda = device.type == "cuda"
        shape = (rows, img_size, img_size, 3)
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(stage_window)]
        self.host_free: List[Optional[torch.cuda.Event]] = \
            [None] * len(self.host)
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        self.next_slot = 0

    def stage(self, rows: np.ndarray):
        """Copy ``rows`` (zero-padded to the lane's rows) into the next
        pinned buffer and start its device copy; returns (device tensor,
        ready event or None)."""
        real = rows.shape[0]
        slot = self.next_slot
        self.next_slot = (slot + 1) % len(self.host)
        if self.host_free[slot] is not None:
            self.host_free[slot].synchronize()  # its last copy has finished
        host = self.host[slot]
        host[:real].copy_(torch.from_numpy(rows))
        host[real:].zero_()
        if self.copy_stream is None:
            return host.clone(), None
        with torch.cuda.stream(self.copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        self.host_free[slot] = ready
        return dev, ready

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class ServingEngine:
    """Fixed-batch PPNet inference over raw uint8 images.

    Args:
      backbone / ppnet: model configuration.
      state_dict: trained weights in the reference layout (fp32); the
        normalization fold is applied here — pass the plain weights.
      batch_size: the fixed chunk (160 by default); PER DEVICE when a mesh
        is given, the chunk then being ``batch_size * mesh.size``.
      compute_dtype: torch.bfloat16 (speed) or torch.float32 (parity).
      with_attn: also return the CLS rollout scores per image.
      stage_window: input chunks staged ahead of compute at most.
      device: "cuda" (default) or "cpu"; ignored with a mesh.
      mesh: a ``parallel.Mesh``: one model replica a mesh device, loaded
        from the same folded weights; device d's replica runs rows
        d*batch_size .. (d+1)*batch_size - 1 of each chunk through its own
        staging buffers and copy stream, and the results come back in
        request order. The forward is batch-parallel throughout, so no
        collective runs.
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
        mesh=None,
    ):
        devices = (list(mesh.devices) if mesh is not None
                   else [resolve_device(device)])
        self.mesh = mesh
        self.device = devices[0]
        self.per_device = batch_size
        self.batch_size = batch_size * len(devices)
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
        model.eval()
        replicas = ([model.to(self.device)] if mesh is None
                    else replicate(model, mesh))
        self._lanes = [_Lane(replica, dev, batch_size, self._img_size,
                             self.stage_window)
                       for replica, dev in zip(replicas, devices)]
        self.model = self._lanes[0].model
        self.models = [lane.model for lane in self._lanes]
        self.last_peak_staged = 0

    def _forward(self, chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The first replica's forward on one device-resident chunk."""
        return self._forward_on(self.model, chunk, self.device)

    def _forward_on(self, model, chunk: torch.Tensor, device
                    ) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), model_precision(model, device):
            out = model(chunk)
        ret = {"logits": out.logits.float()}
        if self.with_attn:
            ret["cls_token_attn"] = out.cls_token_attn
        return ret

    def _push_on(self, model, chunk: torch.Tensor, device
                 ) -> Dict[str, torch.Tensor]:
        with model_precision(model, device):
            out = model.push_forward(chunk)
        return {"cls_token_attn": out.cls_token_attn,
                "proto_acts": out.proto_acts}

    def _stage_chunk(self, images: np.ndarray, start: int):
        """Stage the chunk at ``start``: each lane's rows through its own
        pinned buffer and copy stream; returns [(device rows, ready event
        or None)] a lane."""
        b = self.per_device
        return [lane.stage(images[start + d * b:start + (d + 1) * b])
                for d, lane in enumerate(self._lanes)]

    def _consume(self, staged, forward) -> List[Dict[str, torch.Tensor]]:
        outs = []
        for lane, (dev, ready) in zip(self._lanes, staged):
            if ready is not None:
                stream = torch.cuda.current_stream(lane.device)
                stream.wait_event(ready)
                dev.record_stream(stream)
            outs.append(forward(lane.model, dev, lane.device))
        return outs

    def warmup(self) -> None:
        """Run one forward on a dummy chunk on every replica and wait."""
        for lane in self._lanes:
            dummy = torch.zeros(
                (self.per_device, self._img_size, self._img_size, 3),
                dtype=torch.uint8, device=lane.device,
            )
            self._forward_on(lane.model, dummy, lane.device)
        self._sync()

    def _sync(self) -> None:
        for lane in self._lanes:
            lane.sync()

    def throughput_probe(self, n_images: int = 10240, reps: int = 3) -> dict:
        """Sustained serving rate (img/s) of an n-image request with its
        chunks already on the devices: per-chunk forwards on every replica,
        the concatenation and one tail slice, ending in a synchronize of
        every device.

        Returns {"img_per_sec", "best_img_per_sec", "n_images", "chunks"}.
        """
        rng = np.random.default_rng(0)
        shape = (self.per_device, self._img_size, self._img_size, 3)
        chunks = [
            [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                              ).to(lane.device) for lane in self._lanes]
            for _ in range(0, n_images, self.batch_size)
        ]
        self.warmup()

        def run_once() -> float:
            t0 = time.perf_counter()
            logits = [self._forward_on(lane.model, c, lane.device)["logits"]
                      for parts in chunks
                      for lane, c in zip(self._lanes, parts)]
            torch.cat([lg.to(self.device) for lg in logits])[:n_images]
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
        the chunks in request order, cut to N rows and fetched as fp32
        numpy."""
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
            for out in self._consume(staged[i], forward):
                for key, value in out.items():
                    outs.setdefault(key, []).append(value)
            staged[i] = None  # the chunk's input is consumed
            nxt = i + self.stage_window
            if nxt < len(starts):
                staged.append(self._stage_chunk(images, starts[nxt]))
            self.last_peak_staged = max(
                self.last_peak_staged,
                sum(1 for s in staged if s is not None),
            )
        # gathered on the first lane's device (``.to`` does nothing for one
        # device), then fetched to the host once
        return {key: torch.cat([c.to(self.device) for c in chunks]
                               )[:n].float().cpu().numpy()
                for key, chunks in outs.items()}

    def __call__(self, images: np.ndarray) -> ServingResult:
        """Inference on (N, H, W, 3) uint8 RGB, any N >= 1."""
        out = self._run(images, self._forward_on)
        logits = out["logits"]
        return ServingResult(
            logits=logits,
            top_class=np.argmax(logits, axis=-1).astype(np.int32),
            cls_token_attn=out.get("cls_token_attn"),
        )

    def push_forward(self, images: np.ndarray) -> PushResult:
        """``PPNet.push_forward`` (the interpretability tools' forward) on
        (N, H, W, 3) uint8 RGB, any N >= 1, chunked as ``__call__``."""
        out = self._run(images, self._push_on)
        return PushResult(cls_token_attn=out["cls_token_attn"],
                          proto_acts=out["proto_acts"])
