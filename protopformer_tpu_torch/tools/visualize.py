"""Prototype activation heatmap visualization (port of
``protopformer_tpu/tools/visualize.py``).

Rebuild of the reference's main_visualize.py (ref: main_visualize.py:
34-475): for chosen classes, run the eval-mode ``push_forward``, scatter the
k reserved-token activations back onto the patch grid, and write JET
heatmap overlays, 95th-percentile bounding boxes, discarded-token masks and
(optionally) a 2-D Gaussian fit rendered as a 3-D surface.

The device runs the batched forward (its kernels on CUDA, in true fp32 for
an fp32 model); everything below it (colormaps, bbox search, Gaussian fit,
png writing) is host-side numpy/cv2/matplotlib per image, the JAX
package's code as it is.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from protopformer_tpu_torch.data.preprocess import normalize_images
from protopformer_tpu_torch.models.ppnet import PushOutput
from protopformer_tpu_torch.ops.tokens import topk_sorted_indices
from protopformer_tpu_torch.serving import model_precision


def find_high_activation_crop(
    activation_map: np.ndarray, percentile: float = 95.0
) -> Tuple[int, int, int, int]:
    """Tight bbox around activations above the percentile threshold
    (ref: main_visualize.py:42-63). Returns (y0, y1, x0, x1)."""
    thresh = np.percentile(activation_map, percentile)
    mask = activation_map >= thresh
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    return int(rows[0]), int(rows[-1] + 1), int(cols[0]), int(cols[-1] + 1)


def gaussian_params(act: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Activation-weighted spatial mean + covariance of a 2-D map
    (ref: get_gaussian_params, main_visualize.py:66-80)."""
    h, w = act.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    wsum = act.sum() + 1e-12
    mu = np.array([(act * ys).sum() / wsum, (act * xs).sum() / wsum])
    dy, dx = ys - mu[0], xs - mu[1]
    cov = np.array([
        [(act * dy * dy).sum(), (act * dy * dx).sum()],
        [(act * dx * dy).sum(), (act * dx * dx).sum()],
    ]) / wsum
    return mu, cov


def multivariate_gaussian_surface(
    mu: np.ndarray, cov: np.ndarray, size: int = 150
) -> np.ndarray:
    """Evaluate N(mu, cov) on a size x size meshgrid
    (ref: multivariate_gaussian, main_visualize.py:83-94)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    pos = np.stack([ys, xs], axis=-1)
    det = np.linalg.det(cov)
    inv = np.linalg.inv(cov + 1e-9 * np.eye(2))
    norm = 1.0 / (2 * np.pi * np.sqrt(max(det, 1e-12)))
    d = pos - mu
    exponent = np.einsum("...i,ij,...j->...", d, inv, d)
    return norm * np.exp(-0.5 * exponent)


def save_gaussian_surface_fig(surface: np.ndarray, path: str) -> None:
    """3-D surface render (ref: save_fig, main_visualize.py:97-130)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    h, w = surface.shape
    ys, xs = np.mgrid[0:h, 0:w]
    ax.plot_surface(xs, ys, surface, cmap="jet", linewidth=0)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def scatter_activations_to_grid(
    proto_acts: np.ndarray, cls_attn: np.ndarray, grid_len: int
) -> np.ndarray:
    """Host-side (B, P, K) -> (B, P, grid, grid) scatter via the reserved
    token positions (ref: main_visualize.py:381-388)."""
    B, P, K = proto_acts.shape
    idx = topk_sorted_indices(torch.from_numpy(np.asarray(cls_attn)),
                              K).numpy()  # (B, K)
    g = int(round(grid_len ** 0.5))
    out = np.zeros((B, P, grid_len), np.float32)
    for b in range(B):
        out[b][:, idx[b]] = proto_acts[b]
    return out.reshape(B, P, g, g)


def jet_overlay(img_uint8: np.ndarray, act: np.ndarray,
                alpha: float = 0.7) -> np.ndarray:
    """JET-colormap heatmap overlay (ref: main_visualize.py:400-404,
    0.7 img + 0.3 heatmap blend at :455-460). act is HxW normalized."""
    import cv2

    act_u8 = np.uint8(255 * (act - act.min()) / (act.max() - act.min() + 1e-8))
    heat = cv2.applyColorMap(act_u8, cv2.COLORMAP_JET)[:, :, ::-1]  # RGB
    return np.uint8(alpha * img_uint8 + (1 - alpha) * heat)


def discard_mask_image(
    img_uint8: np.ndarray, cls_attn: np.ndarray, reserve_num: int,
    patch_size: int = 16,
) -> np.ndarray:
    """Black out the discarded patches (ref: get_discard_img,
    main_visualize.py:34-39)."""
    n = cls_attn.shape[-1]
    g = int(round(n ** 0.5))
    keep_idx = np.argsort(-cls_attn)[:reserve_num]
    keep = np.zeros(n, bool)
    keep[keep_idx] = True
    keep = keep.reshape(g, g)
    out = img_uint8.copy()
    for y in range(g):
        for x in range(g):
            if not keep[y, x]:
                out[y * patch_size:(y + 1) * patch_size,
                    x * patch_size:(x + 1) * patch_size] = 0
    return out


@dataclass
class VisualizationConfig:
    """``visual_type`` semantics follow the reference exactly
    (ref: main_visualize.py:143 default 'heatmap', :310 output subdir,
    :440 the only write branch): 'slim_gaussian' writes the full output
    set (bbox'd overlays, 0.7/0.3 blends, discard masks); 'heatmap' — the
    reference's default — writes ONLY the optional Gaussian surface
    figures (when use_gauss), because the reference has no write calls
    outside the slim_gaussian branch. Outputs land under
    ``output_dir/<visual_type>/`` like the reference's visual_dir."""

    output_dir: str = "vis"
    vis_classes: Sequence[int] = tuple(range(10))
    imgs_per_class: int = 20
    use_gauss: bool = False
    percentile: float = 95.0
    visual_type: str = "heatmap"


def push(model, images) -> PushOutput:
    """``model.push_forward`` of a [0, 1] (B, H, W, 3) host or device batch,
    ImageNet-normalized on the model's device; an fp32 model on CUDA runs
    in true fp32."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(images).to(dev, non_blocking=True).float()
    with model_precision(model, dev):
        return model.push_forward(normalize_images(x))


def visualize_prototypes(
    model,
    loader_pairs: Iterable[Tuple[dict, np.ndarray]],
    ppnet_cfg,
    vis_cfg: VisualizationConfig,
    patch_size: int = 16,
) -> List[str]:
    """Write heatmaps/bboxes/masks for each class's local prototypes.

    Args:
      model: a PPNet on the device it runs on.
      loader_pairs: yields ([0,1] float batch dict, matching uint8 view
        images (B, H, W, 3)) — the reference's paired noaug/view loaders
        (main_visualize.py:223-267). ImageNet normalization happens on
        the device here. Rows whose ``valid`` is 0 (the padding of a last
        batch, labelled 0) are skipped, as the reference's loader has none;
        the JAX package draws them as class 0's images (ROADMAP F10).

    Returns list of written file paths.
    """
    import cv2

    if vis_cfg.visual_type not in ("heatmap", "slim_gaussian"):
        raise ValueError(
            f"visual_type must be 'heatmap' or 'slim_gaussian', "
            f"got {vis_cfg.visual_type!r}"
        )
    if vis_cfg.use_gauss:  # where it is missing, fail before the forward
        import matplotlib  # noqa: F401
    out_root = os.path.join(vis_cfg.output_dir, vis_cfg.visual_type)
    os.makedirs(out_root, exist_ok=True)
    write_full_set = vis_cfg.visual_type == "slim_gaussian"
    ppc = ppnet_cfg.num_prototypes_per_class
    written: List[str] = []

    # gather per-class images
    per_class: dict = {c: [] for c in vis_cfg.vis_classes}
    for batch, views in loader_pairs:
        out = push(model, batch["image"])
        cls_attn = out.cls_token_attn.float().cpu().numpy()
        acts = out.proto_acts.float().cpu().numpy()  # (B, P, k, k)
        labels = np.asarray(batch["label"])
        valid = np.asarray(batch.get("valid", np.ones(labels.shape[0])))
        for b in range(labels.shape[0]):
            c = int(labels[b])
            if valid[b] == 0:  # a padded row of the last batch (F10)
                continue
            if c in per_class and len(per_class[c]) < vis_cfg.imgs_per_class:
                per_class[c].append((views[b], cls_attn[b], acts[b]))

    img_size = next(iter(per_class.values()))[0][0].shape[0] if any(
        per_class.values()
    ) else 224

    for c, samples in per_class.items():
        cdir = os.path.join(out_root, f"class_{c}")
        os.makedirs(cdir, exist_ok=True)
        for si, (view, cls_attn, acts) in enumerate(samples):
            B1 = acts[None]  # (1, P, k, k)
            grid_len = cls_attn.shape[-1]
            grid_acts = scatter_activations_to_grid(
                B1.reshape(1, acts.shape[0], -1), cls_attn[None], grid_len
            )[0]  # (P, g, g)
            for j in range(ppc):
                p_idx = c * ppc + j
                act = grid_acts[p_idx]
                act_up = cv2.resize(
                    act, (img_size, img_size),
                    interpolation=cv2.INTER_CUBIC,
                )
                if write_full_set:
                    overlay = jet_overlay(view, act_up)
                    y0, y1, x0, x1 = find_high_activation_crop(
                        act_up, vis_cfg.percentile
                    )
                    boxed = overlay.copy()
                    cv2.rectangle(boxed, (x0, y0), (x1 - 1, y1 - 1),
                                  (255, 255, 0), 2)
                    path = os.path.join(
                        cdir, f"img{si}_proto{j}_overlay.png"
                    )
                    cv2.imwrite(path, boxed[:, :, ::-1])
                    written.append(path)
                if vis_cfg.use_gauss:
                    mu, cov = gaussian_params(act_up.astype(np.float64))
                    surf = multivariate_gaussian_surface(
                        mu * 150.0 / img_size,
                        cov * (150.0 / img_size) ** 2,
                    )
                    gpath = os.path.join(
                        cdir, f"img{si}_proto{j}_gauss.png"
                    )
                    save_gaussian_surface_fig(surf, gpath)
                    written.append(gpath)
            if write_full_set:
                mask_img = discard_mask_image(
                    view, cls_attn, ppnet_cfg.final_reserve_num, patch_size
                )
                mpath = os.path.join(cdir, f"img{si}_discard_mask.png")
                cv2.imwrite(mpath, mask_img[:, :, ::-1])
                written.append(mpath)
    return written
