#!/bin/bash
# Consistency-score evaluation (EvalProtoPNet protocol, reference
# README.md:111-126). Needs the RAW CUB_200_2011 tree (part annotations).
# Usage: sh protopformer_tpu_torch/cli/presets/eval_interpretability.sh $model $weights

model=${1:-deit_tiny_patch16_224}
resume=${2:?usage: eval_interpretability.sh MODEL WEIGHTS}

if [ "$model" = "cait_xxs24_224" ]; then
    reserve_layer_idx=1
else
    reserve_layer_idx=11
fi

python -m protopformer_tpu_torch.cli.eval_interpretability \
    --base_architecture=$model \
    --data_path=${DATA_PATH:-datasets/CUB_200_2011} \
    --prototype_shape 2000 192 1 1 \
    --reserve_layers $reserve_layer_idx \
    --reserve_token_nums 81 \
    --global_proto_per_class=10 \
    --resume=$resume \
    --batch_size=256
