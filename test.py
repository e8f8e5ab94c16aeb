#!/usr/bin/env python
"""Volume-inference CLI — argparse/log surface mirrors the reference
``test.py`` (test.py:24-69, 103-165); inference runs batched per volume on
the jit-compiled model instead of one slice per forward.
"""

import argparse
import logging
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cswin_unet_tpu.config import get_config

parser = argparse.ArgumentParser()
parser.add_argument('--volume_path', type=str,
                    default='./datasets/Synapse/test_vol_h5', help='root dir for validation volume data')
parser.add_argument('--dataset', type=str,
                    default='Synapse', help='experiment_name')
parser.add_argument('--num_classes', type=int,
                    default=9, help='output channel of network')
parser.add_argument('--list_dir', type=str,
                    default='./lists/lists_Synapse', help='list dir')
parser.add_argument('--output_dir', type=str, help='output dir')
parser.add_argument('--max_iterations', type=int, default=30000)
parser.add_argument('--max_epochs', type=int, default=150)
parser.add_argument('--batch_size', type=int, default=24, help='batch_size per gpu')
parser.add_argument('--img_size', type=int, default=224, help='input patch size of network input')
parser.add_argument('--is_savenii', action="store_true", help='whether to save results during inference')
parser.add_argument('--test_save_dir', type=str, default='../predictions', help='saving prediction as nii!')
parser.add_argument('--deterministic', type=int, default=1)
parser.add_argument('--base_lr', type=float, default=0.01)
parser.add_argument('--seed', type=int, default=1234, help='random seed')
parser.add_argument('--cfg', type=str, required=True, metavar="FILE", help='path to config file')
parser.add_argument("--opts", default=None, nargs='+',
                    help="Modify config options by adding 'KEY VALUE' pairs. ")
parser.add_argument('--zip', action='store_true')
parser.add_argument('--cache-mode', type=str, default='part', choices=['no', 'full', 'part'])
parser.add_argument('--resume', help='resume from checkpoint')
parser.add_argument('--accumulation-steps', type=int)
parser.add_argument('--use-checkpoint', action='store_true')
parser.add_argument('--amp-opt-level', type=str, default='O1', choices=['O0', 'O1', 'O2'])
parser.add_argument('--tag', help='tag of experiment')
parser.add_argument('--eval', action='store_true')
parser.add_argument('--throughput', action='store_true')
parser.add_argument('--device_metrics', action='store_true',
                    help='compute dice/hd95 on device (plain-jnp EDT): '
                         'predictions never leave the device; host path '
                         'is used automatically when saving nii')

args = parser.parse_args()
if args.dataset == "Synapse":
    args.volume_path = os.path.join(args.volume_path, "test_vol_h5")
config = get_config(args)


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cswin_unet_tpu.data import SynapseDataset
    from cswin_unet_tpu.eval import VolumeInferencer, inference
    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.utils.checkpoint import load_checkpoint, merge_matching, flatten, unflatten, _backbone_of, _with_backbone
    from cswin_unet_tpu.utils.flops import count_flops_and_params

    random.seed(args.seed)
    np.random.seed(args.seed)

    dataset_config = {
        'Synapse': {'list_dir': './lists/lists_Synapse', 'num_classes': 9, 'z_spacing': 1},
        'kits23': {'list_dir': './lists/kits23', 'num_classes': 4, 'z_spacing': 1},
        'lits17': {'list_dir': './lists/lits17', 'num_classes': 3, 'z_spacing': 1},
    }
    dataset_name = args.dataset
    args.num_classes = dataset_config[dataset_name]['num_classes']
    args.list_dir = dataset_config[dataset_name]['list_dir']
    args.z_spacing = dataset_config[dataset_name]['z_spacing']

    net = build_model(config, img_size=args.img_size, num_classes=args.num_classes)
    params = net.init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, args.img_size, args.img_size, 1))
    )

    snapshot = os.path.join(args.output_dir, 'best_model.npz')
    if not os.path.exists(snapshot):
        snapshot = os.path.join(args.output_dir, f'epoch_{args.max_epochs - 1}.npz')
    loaded, _ = load_checkpoint(snapshot)
    tree = jax.device_get(params)
    merged = merge_matching(flatten(tree), flatten(loaded), log=print)
    params = unflatten(merged)
    print("Loaded model from:", snapshot)
    snapshot_name = snapshot.split('/')[-1]

    log_folder = './test_log/test_log_'
    os.makedirs(log_folder, exist_ok=True)
    logging.basicConfig(filename=os.path.join(log_folder, f"log_{dataset_name}.txt"),
                        level=logging.INFO,
                        format='[%(asctime)s.%(msecs)03d] %(message)s', datefmt='%H:%M:%S',
                        force=True)
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info(str(args))
    logging.info(snapshot_name)

    if args.is_savenii:
        args.test_save_dir = os.path.join(args.output_dir, "predictions")
        test_save_path = args.test_save_dir
        os.makedirs(test_save_path, exist_ok=True)
    else:
        test_save_path = None

    visual_save_dir = "./test_visuals"
    os.makedirs(visual_save_dir, exist_ok=True)
    logging.info(f"Visualizations will be saved to {visual_save_dir}")

    db_test = SynapseDataset(base_dir=args.volume_path, split="test_vol",
                             list_dir=args.list_dir)
    inferencer = VolumeInferencer(net, params,
                                  patch_size=(args.img_size, args.img_size))
    inference(args, inferencer, db_test, test_save_path, visual_save_dir)

    try:
        flops, n_params = count_flops_and_params(net, params, args.img_size)
        print('FLOPs:', flops)
        print('Params:', n_params)
    except Exception as e:
        print(f"Could not calculate FLOPs/Params: {e}")
