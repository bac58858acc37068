"""Interpretability consistency-score CLI (port of
``main_eval_interpretability.py``).

Mirrors the reference's eval_interpretability.py surface
(ref: eval_interpretability.py:96-122 args, README.md:111-126): load a
trained PPNet, run the full CUB test set, score prototype-part consistency
against the CUB part annotations; prints one JSON line
``{"consistency_score": ...}``. ``--resume`` is as ``cli.visualize``'s.
The head is the reference's hard-coded one (200 classes, global branch
on); the model is fp32 on ``--device`` (CUDA unless ``cpu``; TF32 off).
On ``cuda`` with several cards, and a batch that splits over them,
``push_forward`` runs one replica a card (``parallel.make_mesh``).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(
        "ProtoPFormer (PyTorch/CUDA) interpretability eval")
    p.add_argument("--base_architecture", type=str,
                   default="deit_tiny_patch16_224")
    p.add_argument("--data_path", type=str, default="datasets/CUB_200_2011")
    p.add_argument("--prototype_shape", nargs="+", type=int,
                   default=[2000, 192, 1, 1])
    p.add_argument("--reserve_layers", nargs="+", type=int, default=[11])
    p.add_argument("--reserve_token_nums", nargs="+", type=int, default=[81])
    p.add_argument("--global_proto_per_class", type=int, default=10)
    p.add_argument("--resume", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--half_size", type=int, default=36)
    p.add_argument("--part_thresh", type=float, default=0.8)
    p.add_argument("--host_workers", type=int, default=8,
                   help="thread-pool width for the per-image part matching")
    p.add_argument("--seed", type=int, default=1028)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = get_args(argv)
    from PIL import Image

    from protopformer_tpu_torch.checkpoint import load_params
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.core.device import resolve_device
    from protopformer_tpu_torch.data import HostDataLoader
    from protopformer_tpu_torch.data.datasets import build_cub_index
    from protopformer_tpu_torch.data.local_parts import load_cub_parts
    from protopformer_tpu_torch.data.transforms import build_square_transform
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.parallel import make_mesh
    from protopformer_tpu_torch.tools.eval_interpretability import (
        ConsistencyConfig,
        consistency_score,
    )
    from protopformer_tpu_torch.utils import get_logger, set_seed

    dev = resolve_device(args.device)
    logger = get_logger("interpretability")
    set_seed(args.seed, dev)
    backbone = backbone_preset(args.base_architecture, drop_path_rate=0.0)
    ppnet_cfg = PPNetConfig(
        prototype_shape=tuple(args.prototype_shape),
        num_classes=200,
        reserve_layers=tuple(args.reserve_layers),
        reserve_token_nums=tuple(args.reserve_token_nums),
        use_global=True,
        global_proto_per_class=args.global_proto_per_class,
    )
    model = load_params(args.resume, construct_ppnet(backbone, ppnet_cfg))
    model.to(dev)

    index = build_cub_index(args.data_path, train=False)
    base = os.path.join(args.data_path, "CUB_200_2011")
    if not os.path.isdir(base):
        base = args.data_path
    annotations = load_cub_parts(base)

    # original-image sizes: PIL reads only the header for .size, so this is
    # I/O, fanned out over threads
    def _size(item):
        img_id, path = item
        with Image.open(path) as im:
            return int(img_id), im.size

    with cf.ThreadPoolExecutor(max(args.host_workers, 1)) as ex:
        image_sizes = dict(
            ex.map(_size, zip(index.image_ids, index.paths), chunksize=64)
        )

    # protocol transform: plain square Resize((224,224)), NO center crop
    # (ref: eval_interpretability.py:173-176)
    eval_tf = build_square_transform(backbone.img_size)
    loader = HostDataLoader(index, eval_tf, args.batch_size, shuffle=False,
                            num_workers=8)

    def with_positions():
        pos = 0
        for batch in loader:
            B = batch["label"].shape[0]
            batch["position"] = np.arange(pos, pos + B) % len(index)
            pos += int(batch["valid"].sum())
            yield batch

    # push_forward over every card, one replica each, when the default
    # device has several and the batch splits over them (as the JAX CLI
    # shards over its devices)
    mesh = None
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.index is None and cards > 1 and args.batch_size % cards == 0:
        mesh = make_mesh()
        logger.info(f"push_forward over {mesh}")

    score = consistency_score(
        model, with_positions(), annotations,
        np.asarray(index.image_ids), image_sizes, ppnet_cfg,
        ConsistencyConfig(half_size=args.half_size,
                          part_thresh=args.part_thresh,
                          img_size=backbone.img_size),
        logger,
        mesh=mesh,
        host_workers=args.host_workers,
    )
    print(json.dumps({"consistency_score": score}))
    return score


if __name__ == "__main__":
    main()
