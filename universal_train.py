#!/usr/bin/env python
"""Continual-learning CLI (KD + surgical + TPGM) — argparse surface mirrors
the reference ``universal_train.py:26-118``; engine is
``cswin_unet_tpu.train.continual``.
"""

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cswin_unet_tpu.config import get_config

parser = argparse.ArgumentParser()
parser.add_argument('--root_path', type=str,
                    default='./datasets/kits23/train_npz', help='root dir for data')
parser.add_argument('--dataset', type=str,
                    default='kits23', help='experiment_name')
parser.add_argument('--list_dir', type=str,
                    default='./lists/kits23', help='list dir')
parser.add_argument('--stage', type=int, choices=[1, 2], default=1,
                    help='Continual learning stage: 1 (Synapse->kits23), 2 (Synapse+kits23->lits17)')
parser.add_argument('--num_classes_old', type=int, default=9,
                    help='number of classes in the old model')
parser.add_argument('--num_classes_new', type=int, default=4,
                    help='number of classes in the new dataset')
parser.add_argument('--num_classes_lits17', type=int, default=3,
                    help='number of classes in lits17 dataset')
parser.add_argument('--output_dir', type=str, help='output dir')
parser.add_argument('--max_iterations', type=int, default=10000)
parser.add_argument('--max_epochs', type=int, default=50)
parser.add_argument('--batch_size', type=int, default=12, help='batch_size per gpu')
parser.add_argument('--n_gpu', type=int, default=1, help='total gpu')
parser.add_argument('--deterministic', type=int, default=1)
parser.add_argument('--base_lr', type=float, default=0.001)
parser.add_argument('--img_size', type=int, default=224)
parser.add_argument('--seed', type=int, default=1234)
parser.add_argument('--cfg', type=str, required=True, metavar="FILE", help='path to config file')
parser.add_argument('--pretrained_path', type=str, required=True,
                    help='path to pretrained model checkpoint')
parser.add_argument('--data_fraction', type=float, default=1.0,
                    help='fraction of data to use for finetuning (default: 1.0)')
parser.add_argument('--kd_temperature', type=float, default=3.0)
parser.add_argument('--kd_weight', type=float, default=0.5)
parser.add_argument('--freeze_old_classes', action='store_true')
parser.add_argument('--auto_tune', type=str, default='RGN',
                    choices=['none', 'RGN', 'eb-criterion'])
parser.add_argument('--gradient_batches', type=int, default=5)
parser.add_argument('--tpgm_norm_mode', type=str, default='l2', choices=['l2', 'mars'])
parser.add_argument('--tpgm_lr', type=float, default=0.01)
parser.add_argument('--tpgm_iters', type=int, default=200)
parser.add_argument('--tpgm_exclude', nargs='+', default=[])
parser.add_argument('--tpgm_frequency', type=int, default=5)
parser.add_argument('--tpgm_start_epoch', type=int, default=10)
parser.add_argument('--disable_tpgm', action='store_true')
parser.add_argument('--tpgm_data_fraction', type=float, default=0.1)
parser.add_argument("--opts", default=None, nargs='+')
parser.add_argument('--zip', action='store_true')
parser.add_argument('--cache-mode', type=str, default='part', choices=['no', 'full', 'part'])
parser.add_argument('--resume', help='resume from checkpoint')
parser.add_argument('--accumulation-steps', type=int)
parser.add_argument('--use-checkpoint', action='store_true')
parser.add_argument('--amp-opt-level', type=str, default='O1', choices=['O0', 'O1', 'O2'])
parser.add_argument('--tag', help='tag of experiment')
parser.add_argument('--eval', action='store_true')
parser.add_argument('--throughput', action='store_true')

args = parser.parse_args()
config = get_config(args)


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.train.continual import get_stage_info, trainer_continual_surgical_tpgm
    from cswin_unet_tpu.utils.checkpoint import (
        expand_classifier,
        flatten,
        load_checkpoint,
        merge_matching,
        strip_prefixes,
        unflatten,
    )

    random.seed(args.seed)
    np.random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    stage_info = get_stage_info(args)
    old_classes, new_classes, total_classes, dataset_name = stage_info

    # Build the old model and load its pretrained weights strictly.
    old_model = build_model(config, img_size=args.img_size, num_classes=old_classes)
    old_params = old_model.init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, args.img_size, args.img_size, 1))
    )
    print(f"Loading pretrained model from {args.pretrained_path}")
    loaded, _ = load_checkpoint(args.pretrained_path)
    merged = merge_matching(flatten(jax.device_get(old_params)),
                            flatten(loaded), log=print)
    old_params = unflatten(merged)

    # Expand the classifier head: old -> old+new-1 classes (shared background).
    new_model = build_model(config, img_size=args.img_size, num_classes=total_classes)
    new_params = expand_classifier(old_params, total_classes, seed=args.seed)
    print(f"Expanded final layer 'output': {old_classes} -> {total_classes} classes")

    print(f"\n=== Combined Continual Learning Stage {args.stage} + Surgical + TPGM Configuration ===")
    print(f"Dataset: {dataset_name}")
    print(f"Old model classes: {old_classes}")
    print(f"New dataset classes: {new_classes}")
    print(f"Total classes: {total_classes}")
    print(f"KD Temperature: {args.kd_temperature}")
    print(f"KD Weight: {args.kd_weight}")
    print(f"Surgical fine-tuning method: {args.auto_tune}")
    print(f"TPGM enabled: {not args.disable_tpgm}")
    print(f"Data fraction: {args.data_fraction}")
    print(f"Base learning rate: {args.base_lr}")
    print(f"Max epochs: {args.max_epochs}")
    print("=" * 70)

    trainer_continual_surgical_tpgm(
        args, new_model, new_params, old_model, old_params, args.output_dir, stage_info
    )
