"""Export a training checkpoint as a reference-loadable ``.pth`` (port of
``main_export.py``).

Interop path for users of the PyTorch reference: train with
``cli.train``, export with this tool, and keep using the reference's own
offline tooling (``main_visualize.py`` / ``eval_interpretability.py`` load
``{"model": ...}`` .pth dicts — ref: main_visualize.py:287-291,
eval_interpretability.py:154-156). The file is key for key what the JAX
package's ``main_export.py`` writes.

Usage (the train CLI's model flags, plus):

    python -m protopformer_tpu_torch.cli.export \\
        --base_architecture deit_tiny_patch16_224 \\
        --prototype_shape 2000 192 1 1 --reserve_layers 11 \\
        --reserve_token_nums 81 \\
        --resume output/checkpoints --export_path export.pth [--use_ema]

``--resume`` is a checkpoint root (its latest epoch) or one epoch's file,
by default ``<output_dir>/checkpoints``. The checkpoint is restored into
the model the flags describe, on ``--device`` (CUDA unless ``cpu``).
"""

from __future__ import annotations

import torch

from protopformer_tpu_torch.cli.train import config_from_args, get_args_parser


def main(args) -> str:
    from protopformer_tpu_torch.checkpoint import (
        export_ppnet_state_dict,
        save_torch_checkpoint,
    )
    from protopformer_tpu_torch.checkpoint.manager import manager_for
    from protopformer_tpu_torch.core.config import OptimConfig
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.train import create_train_state, make_optimizer

    cfg = config_from_args(args)
    model = construct_ppnet(cfg.backbone, cfg.ppnet, torch.float32)
    tx = make_optimizer(OptimConfig(), model, steps_per_epoch=1)
    template = create_train_state(model, tx, with_ema=args.use_ema,
                                  device=args.device)
    mgr, epoch = manager_for(args.resume or f"{args.output_dir}/checkpoints")
    state, meta = mgr.restore(template, epoch=epoch)
    source = state.ema if args.use_ema else state.model
    sd = export_ppnet_state_dict(source)
    save_torch_checkpoint(args.export_path, sd)
    print(
        f"exported epoch={meta.get('epoch')} "
        f"({'EMA' if args.use_ema else 'raw'} params, "
        f"{len(sd)} tensors) -> {args.export_path}"
    )
    return args.export_path


def get_parser():
    parser = get_args_parser()
    parser.add_argument(
        "--export_path", default="export.pth",
        help="destination .pth (reference {'model': ...} layout)",
    )
    parser.add_argument(
        "--use_ema", action="store_true",
        help="export the EMA parameters instead of the raw ones",
    )
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
