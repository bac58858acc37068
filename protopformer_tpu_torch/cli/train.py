"""Training and evaluation CLI (port of ``main_train.py``), flag-compatible
with the reference's main.py:

    python -m protopformer_tpu_torch.cli.train \\
        --base_architecture=deit_tiny_patch16_224 \\
        --data_set=CUB2011U --data_path=datasets \\
        --prototype_shape 2000 192 1 1 --reserve_layers 11 \\
        --reserve_token_nums 81 --use_global=True --use_ppc_loss=True ...

(``cli/presets/train_{cub,dogs,car}.sh`` hold the reference's presets.)
Runs on CUDA unless ``--device cpu``; with no CUDA device the default
raises. Orchestration (ref: main.py:252-483): logger and metric writer,
seed, model, data, ``--pretrained_ckpt``, optimizer and train state,
mixup, the steps, ``--resume``, then ``--eval`` alone or the epoch loop
with evaluation and checkpoints (``<output_dir>/checkpoints/``, saved when
the epoch is periodic or the best so far).

``--resume`` takes a checkpoint root (its latest epoch), one epoch's file,
``latest``/``true``/``1`` (this run's own root), a reference-layout
``.pth`` (the model's weights only; ``start_epoch`` follows its ``epoch``),
or a URL (``file://`` is copied into the cache; ``http(s)://`` must already
be there, ``checkpoint/pretrained.py``). ``--finetune`` is accepted and
dead, as in the reference.

Several cards, one process each (``parallel/multihost.py``):

    torchrun --nproc_per_node=W -m protopformer_tpu_torch.cli.train ...

Every rank runs on ``cuda:LOCAL_RANK`` (or ``--device`` as given, with
an index), joins the group over ``--dist_backend`` (nccl by default;
gloo for ranks sharing a card or on the CPU), seeds with ``seed + rank``,
reads its ``shard_index_for_process`` of the train and validation sets
and trains data-parallel (``make_train_step(distributed=True)``).
``--batch_size`` is the GLOBAL batch, rounded down to a multiple of W and
split evenly over the ranks, as the JAX CLI rounds it to its devices (the
reference gives it per GPU). The evaluation is always the exact full set,
sharded: the wrapped duplicates of a shard carry ``valid`` 0 and the sums
are all-reduced, so ``--dist_eval`` changes nothing. Rank 0 logs and
saves (a barrier on each side of a save); each rank resumes from the
same file, loaded on the CPU and copied onto its own card. Without
``WORLD_SIZE`` the CLI runs one process on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def str2bool(v) -> bool:
    """Shell-friendly boolean flags (ref: tools/utils.py:26-32)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "ProtoPFormer (PyTorch/CUDA) training and evaluation", add_help=False
    )
    # ProtoPFormer block (ref: main.py:44-73)
    p.add_argument("--base_architecture", type=str,
                   default="deit_tiny_patch16_224")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--prototype_shape", nargs="+", type=int,
                   default=[2000, 192, 1, 1])
    p.add_argument("--prototype_activation_function", type=str, default="log")
    p.add_argument("--add_on_layers_type", type=str, default="regular")
    p.add_argument("--reserve_layers", nargs="+", type=int, default=[11])
    p.add_argument("--reserve_token_nums", nargs="+", type=int, default=[81])
    p.add_argument("--use_global", type=str2bool, default=True)
    p.add_argument("--use_ppc_loss", type=str2bool, default=False)
    p.add_argument("--ppc_cov_thresh", type=float, default=1.0)
    p.add_argument("--ppc_mean_thresh", type=float, default=2.0)
    p.add_argument("--global_coe", type=float, default=0.5)
    p.add_argument("--global_proto_per_class", type=int, default=5)
    p.add_argument("--ppc_cov_coe", type=float, default=0.1)
    p.add_argument("--ppc_mean_coe", type=float, default=0.5)
    # LRs (ref: main.py:64-67)
    p.add_argument("--features_lr", type=float, default=1e-4)
    p.add_argument("--add_on_layers_lr", type=float, default=3e-3)
    p.add_argument("--prototype_vectors_lr", type=float, default=3e-3)
    # model/EMA (ref: main.py:75-90)
    p.add_argument("--model", type=str, default="deit_tiny_patch16_224")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=256,
                   help="the global batch; under torchrun rounded down to "
                        "a multiple of the world size and split evenly "
                        "over the ranks (the reference gives it per GPU)")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--save_ep_freq", type=int, default=400)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--model_ema", type=str2bool, default=True)
    p.add_argument("--model_ema_decay", type=float, default=0.99996)
    # optimizer (ref: main.py:92-104)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--opt-eps", dest="opt_eps", type=float, default=1e-8)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--clip_grad", type=float, default=None)
    # schedule (ref: main.py:105-130)
    p.add_argument("--sched", type=str, default="cosine")
    p.add_argument("--warmup-lr", dest="warmup_lr", type=float, default=1e-6)
    p.add_argument("--min-lr", dest="min_lr", type=float, default=1e-5)
    p.add_argument("--warmup-epochs", dest="warmup_epochs", type=int, default=5)
    p.add_argument("--decay-epochs", dest="decay_epochs", type=float, default=30)
    p.add_argument("--decay-rate", "--dr", dest="decay_rate", type=float,
                   default=0.1)
    p.add_argument("--cooldown-epochs", dest="cooldown_epochs", type=int,
                   default=10)
    # timm schedule noise (ref: main.py:110-114; unused by the presets)
    p.add_argument("--lr-noise", dest="lr_noise", type=float, nargs="+",
                   default=None)
    p.add_argument("--lr-noise-pct", dest="lr_noise_pct", type=float,
                   default=0.67)
    p.add_argument("--lr-noise-std", dest="lr_noise_std", type=float,
                   default=1.0)
    # augmentation (ref: main.py:132-171)
    p.add_argument("--color-jitter", dest="color_jitter", type=float,
                   default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--enable_smoothing", type=str2bool, default=False)
    p.add_argument("--train-interpolation", dest="train_interpolation",
                   type=str, default="bicubic")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", type=str, default="pixel")
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", dest="mixup_prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", dest="mixup_switch_prob",
                   type=float, default=0.5)
    p.add_argument("--enable_mixup", type=str2bool, default=False)
    # data / run (ref: main.py:173-206)
    p.add_argument("--finetune", default="",
                   help="accepted for flag parity; DEAD in the reference "
                        "too (parsed at main.py:173, its only use is "
                        "commented out at :427) — use --pretrained_ckpt "
                        "for backbone weights or --resume for full state")
    p.add_argument("--dist_eval", type=str2bool, default=False,
                   help="accepted for flag parity (ref: main.py:289-297 "
                        "shards val across ranks, with a padding-bias "
                        "warning); this build always evaluates the exact "
                        "full set, sharded over the ranks with a validity "
                        "mask, so the flag is a no-op")
    p.add_argument("--data_set", default="CUB2011U")
    p.add_argument("--data_path", type=str,
                   default="./datasets/cub200_cropped/")
    p.add_argument("--output_dir", default="output/")
    p.add_argument("--seed", default=1028, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_ema", action="store_true",
                   help="evaluate the EMA weights instead of the live ones")
    p.add_argument("--num_workers", default=10, type=int)
    p.add_argument("--pretrained_ckpt", default="",
                   help="backbone weights to load: a .pth path, a URL, or "
                        "a registered architecture name (e.g. "
                        "deit_tiny_patch16_224), its file in the cache "
                        "(checkpoint/pretrained.py; nothing is downloaded)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--native_decode", type=str2bool, default=False,
                   help="decode+resize JPEGs with the native C++ pipeline "
                        "(data/native.py); per-sample PIL fallback for "
                        "non-JPEG files")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default; raises "
                        "without a CUDA device; cuda:LOCAL_RANK under "
                        "torchrun) or cpu")
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="the process group's backend under torchrun: nccl "
                        "(one card a rank) or gloo (ranks sharing a card, "
                        "or on the CPU)")
    return p


def config_from_args(args):
    """Parsed flags -> the port's ``ExperimentConfig``."""
    from protopformer_tpu_torch.core.config import (
        DataConfig,
        ExperimentConfig,
        OptimConfig,
        PPNetConfig,
        TrainConfig,
        backbone_preset,
    )
    from protopformer_tpu_torch.data.datasets import NUM_CLASSES

    backbone = backbone_preset(
        args.base_architecture,
        img_size=args.img_size,
        drop_rate=args.drop,
        drop_path_rate=args.drop_path,
    )
    num_classes = NUM_CLASSES.get(args.data_set, 200)
    ppnet = PPNetConfig(
        prototype_shape=tuple(args.prototype_shape),
        num_classes=num_classes,
        reserve_layers=tuple(args.reserve_layers),
        reserve_token_nums=tuple(args.reserve_token_nums),
        use_global=args.use_global,
        use_ppc_loss=args.use_ppc_loss,
        ppc_cov_thresh=args.ppc_cov_thresh,
        ppc_mean_thresh=args.ppc_mean_thresh,
        global_coe=args.global_coe,
        global_proto_per_class=args.global_proto_per_class,
        prototype_activation_function=args.prototype_activation_function,
        add_on_layers_type=args.add_on_layers_type,
        ppc_cov_coe=args.ppc_cov_coe,
        ppc_mean_coe=args.ppc_mean_coe,
    )
    optim = OptimConfig(
        opt=args.opt,
        opt_eps=args.opt_eps,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        clip_grad=args.clip_grad,
        features_lr=args.features_lr,
        add_on_layers_lr=args.add_on_layers_lr,
        prototype_vectors_lr=args.prototype_vectors_lr,
        sched=args.sched,
        epochs=args.epochs,
        warmup_epochs=args.warmup_epochs,
        warmup_lr=args.warmup_lr,
        min_lr=args.min_lr,
        decay_epochs=args.decay_epochs,
        decay_rate=args.decay_rate,
        cooldown_epochs=args.cooldown_epochs,
        model_ema=args.model_ema,
        model_ema_decay=args.model_ema_decay,
        lr_noise=None if args.lr_noise is None else tuple(args.lr_noise),
        lr_noise_pct=args.lr_noise_pct,
        lr_noise_std=args.lr_noise_std,
        noise_seed=args.seed,
    )
    data = DataConfig(
        data_set=args.data_set,
        data_path=args.data_path,
        input_size=args.input_size,
        batch_size=args.batch_size,
        color_jitter=args.color_jitter,
        aa=args.aa,
        smoothing=args.smoothing,
        enable_smoothing=args.enable_smoothing,
        reprob=args.reprob,
        mixup=args.mixup,
        cutmix=args.cutmix,
        enable_mixup=args.enable_mixup,
        num_workers=args.num_workers,
    )
    train = TrainConfig(
        seed=args.seed,
        output_dir=args.output_dir,
        resume=args.resume,
        start_epoch=args.start_epoch,
        eval_only=args.eval,
        save_ep_freq=args.save_ep_freq,
        dist_eval=args.dist_eval,
        compute_dtype=args.compute_dtype,
    )
    return ExperimentConfig(
        backbone=backbone, ppnet=ppnet, optim=optim, data=data, train=train
    )


_URL = ("http://", "https://", "file://")
_OWN_ROOT = ("latest", "true", "1")


def _model_weights(sd, model):
    """A reference-layout state dict for ``model``'s strict load. Without
    a global branch the file's global prototypes are dropped and the frozen
    ``last_layer_global.weight`` keeps the model's own class-identity
    pattern (the JAX package converts neither)."""
    if not model.config.use_global:
        sd = {k: v for k, v in sd.items() if k != "prototype_vectors_global"}
        sd["last_layer_global.weight"] = model.last_layer_global.weight
    return sd


def main(args) -> dict:
    from protopformer_tpu_torch.checkpoint import (
        CheckpointManager,
        cached_path,
        load_pretrained_backbone,
    )
    from protopformer_tpu_torch.checkpoint.manager import epoch_of, manager_for
    from protopformer_tpu_torch.checkpoint.torch_convert import (
        load_file,
        state_dict_of,
    )
    from protopformer_tpu_torch.core.device import resolve_device
    from protopformer_tpu_torch.data import (
        HostDataLoader,
        MixupCutmix,
        build_dataset_index,
        build_eval_transform,
        build_train_transform,
    )
    from protopformer_tpu_torch.models import construct_ppnet
    from protopformer_tpu_torch.parallel import (
        barrier,
        initialize_multihost,
        local_rank,
        process_index,
        shard_index_for_process,
    )
    from protopformer_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_optimizer,
        make_train_step,
        train_one_epoch,
    )
    from protopformer_tpu_torch.utils import MetricWriter, get_logger, set_seed

    cfg = config_from_args(args)
    resume = cfg.train.resume
    # fail fast on an unusable --resume before the model is built
    if resume and resume not in _OWN_ROOT and not resume.startswith(_URL) \
            and not os.path.isdir(resume) and not os.path.isfile(resume):
        raise FileNotFoundError(
            f"--resume={resume!r} is not a checkpoint directory, .pth file, "
            f"or URL (expected a checkpoint root, one epoch's "
            f"checkpoint-<epoch>.pth, a reference .pth, or a URL)"
        )
    world = int(os.environ.get("WORLD_SIZE", "1"))
    distributed = world > 1
    device = args.device
    if distributed and device == "cuda":
        device = f"cuda:{local_rank()}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    initialize_multihost(num_processes=world, backend=args.dist_backend)
    rank = process_index()
    out_dir = cfg.train.output_dir
    logger = get_logger("train", os.path.join(out_dir, "train-logs"))
    writer = MetricWriter(out_dir)
    generator = set_seed(cfg.train.seed + rank, dev)
    logger.info(f"device: {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else "")
                + (f"; {world} ranks over {args.dist_backend}"
                   if distributed else ""))

    compute_dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
                     else torch.float32)
    model = construct_ppnet(
        cfg.backbone, cfg.ppnet, compute_dtype,
        generator=torch.Generator().manual_seed(cfg.train.seed))

    # data
    train_index = build_dataset_index(cfg.data.data_set, cfg.data.data_path,
                                      train=True)
    val_index = build_dataset_index(cfg.data.data_set, cfg.data.data_path,
                                    train=False)
    img_size = cfg.backbone.img_size
    train_tf = build_train_transform(
        img_size, cfg.data.color_jitter, cfg.data.aa, cfg.data.reprob
    )
    eval_tf = build_eval_transform(img_size)
    eval_path_tf = None
    train_path_tf = None
    if args.native_decode:
        from protopformer_tpu_torch.data import native

        if native.is_available():
            eval_path_tf = native.build_native_eval_transform(img_size)
            train_path_tf = native.build_native_train_transform(
                img_size, cfg.data.color_jitter, cfg.data.aa, cfg.data.reprob
            )
            logger.info("native C++ decode enabled for train + eval pipelines")
        else:
            logger.warning("--native_decode requested but libppf_image is "
                           "unavailable; using PIL")
    logger.info(
        f"train: {len(train_index)} samples / val: {len(val_index)} samples"
    )
    if distributed:
        train_index = shard_index_for_process(train_index)
        val_index = shard_index_for_process(val_index)

    def _round_to_ranks(bs: int) -> int:
        return max(world, (bs // world) * world)

    train_bs = _round_to_ranks(cfg.data.batch_size)
    train_loader = HostDataLoader(
        train_index, train_tf, train_bs // world, shuffle=True,
        seed=cfg.train.seed + rank, drop_last=True,
        num_workers=cfg.data.num_workers, path_transform=train_path_tf,
    )
    # val batch = 1.5x train batch (ref: main.py:312), split over the ranks
    val_loader = HostDataLoader(
        val_index, eval_tf,
        _round_to_ranks(int(1.5 * cfg.data.batch_size)) // world,
        shuffle=False, seed=cfg.train.seed + rank,
        num_workers=cfg.data.num_workers, path_transform=eval_path_tf,
    )

    if args.pretrained_ckpt:
        model.features.load_state_dict(load_pretrained_backbone(
            args.pretrained_ckpt, cfg.backbone, device="cpu").state_dict())
        logger.info(f"loaded pretrained backbone from {args.pretrained_ckpt}")

    steps_per_epoch = len(train_loader)
    tx = make_optimizer(cfg.optim, model, steps_per_epoch)
    state = create_train_state(model, tx, with_ema=cfg.optim.model_ema,
                               device=dev)

    smoothing = cfg.data.smoothing if cfg.data.enable_smoothing else 0.0
    mixup = None
    if cfg.data.enable_mixup and (cfg.data.mixup > 0 or cfg.data.cutmix > 0):
        mixup = MixupCutmix(
            mixup_alpha=cfg.data.mixup, cutmix_alpha=cfg.data.cutmix,
            prob=cfg.data.mixup_prob, switch_prob=cfg.data.mixup_switch_prob,
            label_smoothing=smoothing, num_classes=cfg.ppnet.num_classes,
        )
    # every rank mixes its own rows under one lambda (ROADMAP F11)
    train_step = make_train_step(model, cfg.ppnet, cfg.optim,
                                 smoothing=0.0 if mixup else smoothing,
                                 mixup=mixup, device=dev,
                                 distributed=distributed,
                                 mixup_seed=cfg.train.seed)
    eval_step = make_eval_step(cfg.ppnet.use_global, device=dev,
                               distributed=distributed)

    if args.finetune:
        logger.warning(
            "--finetune is accepted for flag parity but dead in the "
            "reference (main.py:173, use commented at :427); "
            "use --pretrained_ckpt or --resume"
        )

    ckpt_mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    start_epoch = cfg.train.start_epoch
    if resume:
        if resume.startswith(_URL):
            resume = cached_path(resume)
        if os.path.isfile(resume) and epoch_of(resume) is None:
            # a reference-layout .pth (ref: main.py:397-407): the model's
            # weights only; the optimizer and the EMA start afresh
            ckpt = load_file(resume)
            state.model.load_state_dict(_model_weights(
                state_dict_of(ckpt), state.model), strict=True)
            if isinstance(ckpt, dict) and "epoch" in ckpt:
                start_epoch = int(ckpt["epoch"]) + 1
            logger.warning(
                f"resumed MODEL weights from {cfg.train.resume}; the "
                "optimizer and EMA state restart"
            )
        else:
            resume_mgr, epoch_arg = ((ckpt_mgr, None) if resume in _OWN_ROOT
                                     else manager_for(resume))
            # the file holds rank 0's generator; the other ranks keep
            # their own seed + rank streams
            state, meta = resume_mgr.restore(
                state, epoch=epoch_arg,
                generator=generator if rank == 0 else None)
            start_epoch = int(meta.get("epoch", -1)) + 1
            logger.info(f"resumed from epoch {start_epoch - 1} ({resume})")

    if cfg.train.eval_only:
        eval_model = (state.ema if args.eval_ema and state.ema is not None
                      else state.model)
        stats = evaluate(eval_step, eval_model, val_loader, logger,
                         cfg.ppnet.use_global)
        if rank == 0:
            print(json.dumps(stats))
        writer.close()
        _leave(distributed)
        return stats

    best_acc = 0.0
    global_iter = 0
    epoch_stats = []
    for epoch in range(start_epoch, cfg.optim.epochs):
        t0 = time.perf_counter()
        state, train_stats, global_iter = train_one_epoch(
            train_step, state, train_loader, epoch, generator, cfg,
            writer, logger, global_iter,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        img_per_sec = steps_per_epoch * train_bs / train_s
        val_stats = evaluate(eval_step, state.model, val_loader, logger,
                             cfg.ppnet.use_global)
        writer.write(epoch, {
            "epoch/train_loss": train_stats.get("loss", 0.0),
            "epoch/train_img_per_sec": img_per_sec,
            "epoch/val_acc1": val_stats["acc1"],
            "epoch/val_acc5": val_stats["acc5"],
            "epoch/val_loss": val_stats["loss"],
            **({"epoch/val_global_acc1": val_stats["global_acc1"],
                "epoch/val_local_acc1": val_stats["local_acc1"]}
               if "global_acc1" in val_stats else {}),
        })
        periodic = (epoch + 1) % cfg.train.save_ep_freq == 0
        is_best = val_stats["acc1"] > best_acc
        if is_best:
            best_acc = val_stats["acc1"]
        save_s = None
        if periodic or is_best:
            t_save = time.perf_counter()
            barrier()
            if rank == 0:
                ckpt_mgr.save(
                    epoch, state,
                    {"val_acc1": val_stats["acc1"], "best": is_best},
                    generator=generator, args=vars(args),
                )
            barrier()
            save_s = time.perf_counter() - t_save
        epoch_stats.append({"epoch": epoch, "train_seconds": train_s,
                            "img_per_sec": img_per_sec,
                            "save_seconds": save_s, **val_stats})
        logger.info(
            f"epoch {epoch} done in {time.perf_counter() - t0:.1f}s "
            f"({img_per_sec:.1f} img/s fed) acc1={val_stats['acc1']:.3f} "
            f"best={best_acc:.3f}"
            + (f" saved in {save_s:.3f}s" if save_s is not None else "")
        )
    writer.close()
    _leave(distributed)
    return {"best_acc1": best_acc, "epochs": epoch_stats}


def _leave(distributed: bool) -> None:
    if distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        "ProtoPFormer (PyTorch/CUDA)", parents=[get_args_parser()]
    )
    main(parser.parse_args())
