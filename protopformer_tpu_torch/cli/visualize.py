"""Prototype-activation visualization CLI (port of ``main_visualize.py``).

Mirrors the reference's main_visualize.py surface (ref: main_visualize.py:
133-214 args; ``cli/presets/visualize.sh``): load a trained PPNet, pick
classes, write heatmap overlays / bboxes / discard masks (and optional
Gaussian 3-D surfaces) under ``--output_dir``. ``--resume`` is a
reference-layout ``.pth`` (``cli.export``'s or the JAX package's
``main_export.py``'s), one of ``cli.train``'s epoch files (its ``model``)
or a checkpoint root (its latest epoch). The model is fp32 and runs on
``--device`` (CUDA unless ``cpu``; TF32 off).
"""

from __future__ import annotations

import argparse

import numpy as np

from protopformer_tpu_torch.cli.train import str2bool


def get_args(argv=None):
    p = argparse.ArgumentParser("ProtoPFormer (PyTorch/CUDA) visualization")
    p.add_argument("--base_architecture", type=str,
                   default="deit_tiny_patch16_224")
    p.add_argument("--data_set", default="CUB2011U")
    p.add_argument("--data_path", type=str, default="datasets/cub200_cropped")
    p.add_argument("--prototype_shape", nargs="+", type=int,
                   default=[2000, 192, 1, 1])
    p.add_argument("--reserve_layers", nargs="+", type=int, default=[11])
    p.add_argument("--reserve_token_nums", nargs="+", type=int, default=[81])
    p.add_argument("--global_proto_per_class", type=int, default=10)
    p.add_argument("--use_global", type=str2bool, default=True)
    p.add_argument("--resume", type=str, required=True,
                   help="weights: a .pth, an epoch file or a checkpoint root")
    p.add_argument("--output_dir", type=str, default="vis")
    p.add_argument("--vis_classes", nargs="+", type=int,
                   default=list(range(10)))
    p.add_argument("--imgs_per_class", type=int, default=20)
    p.add_argument("--use_gauss", action="store_true")
    p.add_argument("--use_train_imgs", action="store_true",
                   help="visualize over the TRAIN split (the reference "
                        "hardcodes use_train_imgs=False at "
                        "main_visualize.py:297; exposed here as a flag "
                        "with the same default)")
    p.add_argument("--visual_type", type=str, default="heatmap",
                   choices=["heatmap", "slim_gaussian"],
                   help="reference default 'heatmap' writes only the "
                        "optional Gaussian figures; 'slim_gaussian' writes "
                        "the full overlay/bbox/mask set "
                        "(ref: main_visualize.py:143,440)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=1028)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = get_args(argv)
    from protopformer_tpu_torch.checkpoint import load_params
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.core.device import resolve_device
    from protopformer_tpu_torch.data import (
        HostDataLoader,
        build_dataset_index,
        build_eval_transform,
        build_view_transform,
    )
    from protopformer_tpu_torch.data.datasets import NUM_CLASSES
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.tools.visualize import (
        VisualizationConfig,
        visualize_prototypes,
    )
    from protopformer_tpu_torch.utils import set_seed

    dev = resolve_device(args.device)
    set_seed(args.seed, dev)
    backbone = backbone_preset(args.base_architecture, drop_path_rate=0.0)
    ppnet_cfg = PPNetConfig(
        prototype_shape=tuple(args.prototype_shape),
        num_classes=NUM_CLASSES.get(args.data_set, 200),
        reserve_layers=tuple(args.reserve_layers),
        reserve_token_nums=tuple(args.reserve_token_nums),
        use_global=args.use_global,
        global_proto_per_class=args.global_proto_per_class,
    )
    model = load_params(args.resume, construct_ppnet(backbone, ppnet_cfg))
    model.to(dev)

    # paired normalized + raw-view loaders (ref: main_visualize.py:223-267;
    # split switch ref: :297-299)
    index = build_dataset_index(
        args.data_set, args.data_path, train=args.use_train_imgs
    )
    eval_tf = build_eval_transform(backbone.img_size)
    view_tf = build_view_transform(backbone.img_size)
    loader = HostDataLoader(index, eval_tf, args.batch_size, shuffle=False,
                            num_workers=8)

    def pairs():
        view_loader = HostDataLoader(
            index, lambda im, rng: view_tf(im).astype(np.float32),
            args.batch_size, shuffle=False, num_workers=8,
        )
        for batch, vbatch in zip(loader, view_loader):
            yield batch, vbatch["image"].astype(np.uint8)

    vis_cfg = VisualizationConfig(
        output_dir=args.output_dir,
        vis_classes=args.vis_classes,
        imgs_per_class=args.imgs_per_class,
        use_gauss=args.use_gauss,
        visual_type=args.visual_type,
    )
    written = visualize_prototypes(
        model, pairs(), ppnet_cfg, vis_cfg, patch_size=backbone.patch_size,
    )
    print(f"wrote {len(written)} files under {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
