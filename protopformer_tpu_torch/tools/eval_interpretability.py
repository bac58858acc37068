"""Interpretability consistency score, EvalProtoPNet protocol (port of
``protopformer_tpu/tools/eval_interpretability.py``).

Rebuild of the reference's eval_interpretability.py (ref:
eval_interpretability.py:96-337): for every CUB test image, take the
target class's ``proto_per_class`` local prototype activation maps
(``push_forward``), scatter them from the k reserved tokens to the patch
grid, bicubic-upsample to 224, place a (2*half_size)^2 box at the argmax
clamped to the image (half_size=36 -> 72x72, ref :183,:271-273), and
record which of the 15 annotated bird parts fall inside the box — EVERY
visible part counts; the bird bbox is never consulted (ref :247-253).
Images go through a plain square ``Resize((224,224))`` with no crop (ref
:173-176 — data.transforms.build_square_transform), and part coordinates
rescale with int truncation (ref :251-253). A prototype is *consistent* if
some part is hit in >= part_thresh (0.8) of the class images where that
part is visible; the Consistency Score is the mean over all prototypes
(ref: :309-337).

Device/host split: the batched ``push_forward`` runs on the model's device
(its kernels on CUDA, true fp32 for an fp32 model) and gathers the label's
maps there; the per-image box/part matching is O(15) numpy work that
overlaps the next batch's forward.
"""

from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from protopformer_tpu_torch.data.local_parts import CubPartAnnotations
from protopformer_tpu_torch.parallel.mesh import replicate, shard_batch
from protopformer_tpu_torch.tools.visualize import (
    push,
    scatter_activations_to_grid,
)


@dataclass
class ConsistencyConfig:
    half_size: int = 36  # 72x72 box (ref: eval_interpretability.py:183)
    part_thresh: float = 0.8  # (ref: :184)
    img_size: int = 224
    num_parts: int = 15


def part_hits_for_image(
    act_maps: np.ndarray,  # (ppc, g, g) scattered grid activations
    part_locs: List[Tuple[int, int, int]],  # visible (part_id, int x, int y)
    img_width: int,
    img_height: int,
    cfg: ConsistencyConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-prototype part-hit rows for one image — protocol-exact port of the
    reference's inner loop (ref: eval_interpretability.py:244-284).

    Every visible annotated part counts (the reference never filters by the
    bird bbox, :247-253); coordinates are rescaled with int truncation
    (``int(img_size * (x / w))``, :251-253); the 2*half_size activation box
    is clamped to the image (:271-273); the hit test is the closed-interval
    ``in_bbox`` (:279-282, local_parts.py:8-9).

    Returns (hits (ppc, num_parts) 0/1, visible (num_parts,) 0/1).
    """
    import cv2

    ppc = act_maps.shape[0]
    hits = np.zeros((ppc, cfg.num_parts), np.float32)
    visible = np.zeros((cfg.num_parts,), np.float32)
    scaled_parts = []
    for part_id, x, y in part_locs:
        visible[part_id - 1] = 1.0
        scaled_parts.append((
            part_id - 1,
            int(cfg.img_size * (x / img_width)),
            int(cfg.img_size * (y / img_height)),
        ))

    for j in range(ppc):
        up = cv2.resize(
            act_maps[j], (cfg.img_size, cfg.img_size),
            interpolation=cv2.INTER_CUBIC,
        )
        # row-major first max == np.where(up == up.max())[...][0] (ref :270)
        cy, cx = np.unravel_index(np.argmax(up), up.shape)
        y0 = max(0, cy - cfg.half_size)
        y1 = min(cfg.img_size, cy + cfg.half_size)
        x0 = max(0, cx - cfg.half_size)
        x1 = min(cfg.img_size, cx + cfg.half_size)
        for pid, px, py in scaled_parts:
            if y0 <= py <= y1 and x0 <= px <= x1:
                hits[j, pid] = 1.0
    return hits, visible


def consistency_score(
    model,
    loader,
    annotations: CubPartAnnotations,
    image_ids: np.ndarray,
    image_sizes: Dict[int, Tuple[int, int]],
    ppnet_cfg,
    cfg: Optional[ConsistencyConfig] = None,
    logger=None,
    mesh=None,
    host_workers: int = 0,
) -> float:
    """Consistency Score over a test loader (ref: :190-337).

    The device and host halves are pipelined one batch deep: the forward
    of batch k+1 is launched (asynchronously on CUDA) BEFORE batch k's
    outputs are fetched and matched. With ``host_workers > 0`` the
    per-image box/part matching additionally fans out over a thread pool
    (cv2 releases the GIL in resize). Both are bit-neutral: every image's
    (hits, visible) contribution is an independent additive term.

    Args:
      model: a PPNet on the device it runs on.
      loader: yields batches with 'image' ([0,1] floats from the SQUARE
        resize transform — data.transforms.build_square_transform, matching
        ref :173-176; normalization happens on the device here), 'label',
        'valid', and 'position' (index into image_ids, so padded samples
        are skipped).
      image_ids: dataset-native CUB ids aligned with loader order.
      image_sizes: id -> (width, height) of the ORIGINAL image.
      mesh: a ``parallel.Mesh``: one replica of ``model`` a mesh device,
        each running ``push_forward`` on its contiguous slice of the batch
        (the batch must split evenly), as the JAX package shards the batch
        on its mesh's data axis; the hit counts equal one device's.
      host_workers: thread-pool width for the host matching (0 = inline).
    """
    cfg = cfg or ConsistencyConfig()
    ppc = ppnet_cfg.num_prototypes_per_class
    P = ppnet_cfg.num_prototypes
    replicas = None if mesh is None else replicate(model, mesh)

    # the label's ppc maps gathered on the device: fetching the full
    # (B, P, k, k) tensor costs ~166 MB a batch at B=256, P=2000; the
    # gather is a bit-neutral reorder of the reference's host-side select
    # (ref :198-202), (B, ppc, k, k) ~ 0.8 MB
    def dispatch_one(net, images, labels):
        dev = next(net.parameters()).device
        with torch.inference_mode():
            out = push(net, images)
            lab = torch.as_tensor(labels, device=dev).long()
            idx = lab[:, None] * ppc + torch.arange(ppc, device=dev)[None, :]
            k = out.proto_acts.shape[-1]
            sel = out.proto_acts.gather(
                1, idx[:, :, None, None].expand(-1, -1, k, k))
        return out.cls_token_attn, sel

    def dispatch(images, labels):
        """[(cls_attn, sel)] a replica, in batch order."""
        labels = np.asarray(labels)
        if mesh is None:
            return [dispatch_one(model, images, labels)]
        return [dispatch_one(net, part["image"], part["label"])
                for net, part in zip(replicas, shard_batch(
                    {"image": images, "label": labels}, mesh))]

    # per-prototype accumulators
    hit_sum = np.zeros((P, cfg.num_parts), np.float64)
    vis_sum = np.zeros((P, cfg.num_parts), np.float64)
    pool = (
        cf.ThreadPoolExecutor(host_workers) if host_workers > 0 else None
    )
    pending: List[Tuple[int, "cf.Future"]] = []
    seen = 0

    def match_batch(outs, batch):
        nonlocal seen
        cls_attn = np.concatenate([o[0].float().cpu().numpy() for o in outs])
        sel = np.concatenate(  # (B, ppc, k, k)
            [o[1].float().cpu().numpy() for o in outs])
        labels = np.asarray(batch["label"])
        valid = np.asarray(batch.get("valid", np.ones(labels.shape[0])))
        pos = np.asarray(batch["position"])
        B = labels.shape[0]
        K = sel.shape[-1] ** 2
        grid_len = cls_attn.shape[-1]
        grid = scatter_activations_to_grid(
            sel.reshape(B, ppc, K), cls_attn, grid_len
        )  # (B, ppc, g, g)
        for b in range(B):
            if valid[b] == 0:
                continue
            img_id = int(image_ids[pos[b]])
            if img_id not in annotations.id_to_part_loc:
                continue
            w, h = image_sizes[img_id]
            args = (
                grid[b], annotations.id_to_part_loc[img_id], w, h, cfg
            )
            base = int(labels[b]) * ppc
            if pool is not None:
                pending.append((base, pool.submit(part_hits_for_image, *args)))
            else:
                hits, vis = part_hits_for_image(*args)
                hit_sum[base:base + ppc] += hits
                vis_sum[base:base + ppc] += vis[None, :]
            seen += 1
        if logger is not None and seen % 500 < B:
            logger.info(f"consistency eval: {seen} images")

    try:
        # one-deep pipeline: dispatch k+1, then fetch/match k
        inflight = None
        for batch in loader:
            out = dispatch(batch["image"], batch["label"])
            if inflight is not None:
                match_batch(*inflight)
            inflight = (out, batch)
        if inflight is not None:
            match_batch(*inflight)
        for base, fut in pending:
            hits, vis = fut.result()
            hit_sum[base:base + ppc] += hits
            vis_sum[base:base + ppc] += vis[None, :]
    finally:
        if pool is not None:
            pool.shutdown()

    score = aggregate_score(hit_sum, vis_sum, cfg.part_thresh)
    if logger is not None:
        logger.info(f"Consistency Score: {score:.2f} over {P} prototypes")
    return score


def aggregate_score(
    hit_sum: np.ndarray,  # (P, num_parts) per-prototype part-hit counts
    vis_sum: np.ndarray,  # (P, num_parts) per-part visible-image counts
    part_thresh: float = 0.8,
) -> float:
    """Reference aggregation (ref: :313-337): per prototype, part hit rate =
    hits / visible-count (zero counts clamped to 1, :320-321); a prototype is
    effective iff some part's rate >= part_thresh; score = mean * 100."""
    rates = hit_sum / np.where(vis_sum == 0, 1.0, vis_sum)
    effective = (rates >= part_thresh).any(axis=1)
    return 100.0 * float(effective.mean())
