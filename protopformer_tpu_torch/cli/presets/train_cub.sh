#!/bin/bash
# CUB-200-2011 preset (mirrors the reference's scripts/train_cub.sh
# hyperparameters: 2000 prototypes x 192, 10 global per class, reserve 81,
# PPC cov 0.1 / mean 0.5, AdamW cosine 200 epochs).
# Usage: sh protopformer_tpu_torch/cli/presets/train_cub.sh $model $batch_size
# One process drives one CUDA card (--device cuda, the default).

model=${1:-deit_tiny_patch16_224}
batch_size=${2:-128}
seed=1028

if [ "$model" = "cait_xxs24_224" ]; then
    reserve_layer_idx=1
else
    reserve_layer_idx=11
fi

# Pretrained backbone: the reference fine-tunes FB-hosted timm weights
# (ref: tools/deit_features.py:12-21, deit_models_attn.py:292-296). Nothing
# is downloaded: place the .pth at pretrained/$model.pth (or set
# PRETRAINED_CKPT=/path/to.pth); it is loaded into the backbone at startup.
# Without it, training starts from random init (warned).
pretrained=${PRETRAINED_CKPT:-pretrained/$model.pth}
if [ -f "$pretrained" ]; then
    pretrained_arg="--pretrained_ckpt=$pretrained"
else
    echo "WARNING: no pretrained checkpoint at $pretrained - training from random init" >&2
    pretrained_arg=""
fi

python -m protopformer_tpu_torch.cli.train \
    $pretrained_arg \
    --base_architecture=$model \
    --data_set=CUB2011U \
    --data_path=${DATA_PATH:-datasets} \
    --input_size=224 \
    --output_dir=output_cosine/CUB2011U/$model/$seed \
    --model=$model \
    --batch_size=$batch_size \
    --seed=$seed \
    --opt=adamw \
    --sched=cosine \
    --warmup-epochs=5 \
    --warmup-lr=1e-4 \
    --decay-epochs=10 \
    --decay-rate=0.1 \
    --weight_decay=0.05 \
    --epochs=200 \
    --features_lr=1e-4 \
    --add_on_layers_lr=3e-3 \
    --prototype_vectors_lr=3e-3 \
    --prototype_shape 2000 192 1 1 \
    --reserve_layers $reserve_layer_idx \
    --reserve_token_nums 81 \
    --use_global=True \
    --use_ppc_loss=True \
    --ppc_cov_thresh=1. \
    --ppc_mean_thresh=2. \
    --global_coe=0.5 \
    --global_proto_per_class=10 \
    --ppc_cov_coe=0.1 \
    --ppc_mean_coe=0.5
