#!/bin/bash
# Stanford Cars preset (reference scripts/train_car.sh: 1960 prototypes,
# 5 global per class, reserve 121, features_lr 4e-4).
# Usage: sh protopformer_tpu_torch/cli/presets/train_car.sh $model $batch_size

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
    --data_set=Car \
    --data_path=${DATA_PATH:-datasets/stanford_cars} \
    --input_size=224 \
    --output_dir=output_cosine/Car/$model/$seed \
    --model=$model \
    --batch_size=$batch_size \
    --seed=$seed \
    --opt=adamw \
    --sched=cosine \
    --warmup-epochs=5 \
    --warmup-lr=1e-4 \
    --weight_decay=0.05 \
    --epochs=200 \
    --features_lr=4e-4 \
    --add_on_layers_lr=3e-3 \
    --prototype_vectors_lr=3e-3 \
    --prototype_shape 1960 192 1 1 \
    --reserve_layers $reserve_layer_idx \
    --reserve_token_nums 121 \
    --use_global=True \
    --use_ppc_loss=True \
    --ppc_cov_thresh=1. \
    --ppc_mean_thresh=2. \
    --global_coe=0.5 \
    --global_proto_per_class=5 \
    --ppc_cov_coe=0.1 \
    --ppc_mean_coe=0.5
