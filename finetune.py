#!/usr/bin/env python
"""Legacy surgical fine-tuning CLI — mirrors reference ``finetune.py``
(grid over (lr, wd), per-group RGN reweighting each batch); engine is
``cswin_unet_tpu.train.finetune``.
"""

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cswin_unet_tpu.config import get_config

parser = argparse.ArgumentParser()
parser.add_argument('--pretrained_ckpt', type=str,
                    default='./pretrain/epoch_149.npz',
                    help='Path to pre-trained checkpoint')
parser.add_argument('--root_path', type=str,
                    default='./datasets/Synapse_blurred/train_npz')
parser.add_argument('--dataset', type=str, default='Synapse', help='Dataset name')
parser.add_argument('--list_dir', type=str, default='./lists/lists_Synapse_blurred')
parser.add_argument('--num_classes', type=int, default=9)
parser.add_argument('--output_dir', type=str, required=True)
parser.add_argument('--max_epochs', type=int, default=51)
parser.add_argument('--batch_size', type=int, default=24)
parser.add_argument('--base_lr', type=float, default=0.001)
parser.add_argument('--seed', type=int, default=1234)
parser.add_argument('--cfg', type=str, required=True, metavar="FILE")
parser.add_argument('--img_size', type=int, default=224)
parser.add_argument('--n_gpu', type=int, default=2)
parser.add_argument('--deterministic', type=int, default=1)
parser.add_argument('--save_interval', type=int, default=10)
parser.add_argument('--auto_tune', type=str, default='RGN',
                    choices=['RGN', 'eb-criterion', 'none'])
parser.add_argument('--zip', action='store_true')
parser.add_argument('--cache-mode', type=str, default='part', choices=['no', 'full', 'part'])
parser.add_argument("--opts", default=None, nargs='+')
parser.add_argument('--resume', help='resume from checkpoint')
parser.add_argument('--accumulation-steps', type=int)
parser.add_argument('--use-checkpoint', action='store_true')
parser.add_argument('--amp-opt-level', type=str, default='O1', choices=['O0', 'O1', 'O2'])
parser.add_argument('--tag', help='tag of experiment')
parser.add_argument('--eval', action='store_true')
parser.add_argument('--throughput', action='store_true')
args = parser.parse_args()

config = get_config(args)
config.defrost()
config.MODEL.PRETRAIN_CKPT = args.pretrained_ckpt
config.freeze()


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.train.finetune import surgical_trainer
    from cswin_unet_tpu.utils.checkpoint import load_from_pretrained

    random.seed(args.seed)
    np.random.seed(args.seed)

    model = build_model(config, img_size=args.img_size, num_classes=args.num_classes)
    params = model.init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, args.img_size, args.img_size, 1))
    )
    if os.path.exists(args.pretrained_ckpt) or os.path.exists(args.pretrained_ckpt + ".npz"):
        params = load_from_pretrained(params, args.pretrained_ckpt)
        print(f"Loaded pretrained weights from {args.pretrained_ckpt}")

    os.makedirs(args.output_dir, exist_ok=True)
    surgical_trainer(args, model, params, args.output_dir)
