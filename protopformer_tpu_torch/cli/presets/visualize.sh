#!/bin/bash
# Prototype activation visualization preset (mirrors the reference's
# scripts/visualize.sh surface).
# Usage: sh protopformer_tpu_torch/cli/presets/visualize.sh $model $weights

model=${1:-deit_tiny_patch16_224}
resume=${2:?usage: visualize.sh MODEL WEIGHTS}

if [ "$model" = "cait_xxs24_224" ]; then
    reserve_layer_idx=1
else
    reserve_layer_idx=11
fi

python -m protopformer_tpu_torch.cli.visualize \
    --base_architecture=$model \
    --data_set=CUB2011U \
    --data_path=${DATA_PATH:-datasets} \
    --prototype_shape 2000 192 1 1 \
    --reserve_layers $reserve_layer_idx \
    --reserve_token_nums 81 \
    --global_proto_per_class=10 \
    --resume=$resume \
    --output_dir=vis/$model \
    --vis_classes 0 1 2 3 4 5 6 7 8 9 \
    --use_gauss \
    --visual_type=slim_gaussian
