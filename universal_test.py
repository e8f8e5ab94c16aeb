#!/usr/bin/env python
"""Continual-evaluation CLI — mirrors reference ``universal_test.py``:
checkpoint discovery (file or directory glob), head-shape task
autodetection, class-channel selection per test dataset, batched volume
inference with the same log lines.
"""

import argparse
import logging
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cswin_unet_tpu.config import get_config

# Class-channel mappings of the expanded continual head
# (reference universal_test.py:27-40).
CLASS_MAPPINGS = {
    "synapse": {"classes": 9, "indices": list(range(9))},
    "kits23": {"classes": 4, "indices": [0] + list(range(9, 12))},
    "lits17": {"classes": 3, "indices": [0] + list(range(12, 14))},
}

TASK_CLASSES = {"task1": 9, "task2": 12, "task3": 14}
CLASS_TO_TASK = {9: "task1", 12: "task2", 14: "task3"}

parser = argparse.ArgumentParser()
parser.add_argument('--volume_path', type=str, required=True,
                    help='root dir for validation volume data')
parser.add_argument('--test_dataset', type=str, required=True,
                    choices=['synapse', 'kits23', 'lits17'])
parser.add_argument('--model_path', type=str, required=True,
                    help='path to trained model checkpoint')
parser.add_argument('--model_task_level', type=str,
                    choices=['task1', 'task2', 'task3'],
                    help='which task level the model was trained up to (auto-detected if absent)')
parser.add_argument('--list_dir', type=str,
                    help='list dir (auto-set based on test_dataset if not provided)')
parser.add_argument('--output_dir', type=str, required=True, help='output dir for results')
parser.add_argument('--batch_size', type=int, default=1, help='batch_size for testing')
parser.add_argument('--img_size', type=int, default=224)
parser.add_argument('--is_savenii', action="store_true")
parser.add_argument('--test_save_dir', type=str, default='./predictions')
parser.add_argument('--deterministic', type=int, default=1)
parser.add_argument('--seed', type=int, default=1234)
parser.add_argument('--cfg', type=str, required=True, metavar="FILE")
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
parser.add_argument('--device_metrics', action='store_true',
                    help='compute dice/hd95 on device (plain-jnp EDT): '
                         'predictions never leave the device; host path '
                         'is used automatically when saving nii')

args = parser.parse_args()
config = get_config(args)

LIST_DIRS = {
    'synapse': './lists/lists_Synapse',
    'kits23': './lists/kits23',
    'lits17': './lists/lits17',
}


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cswin_unet_tpu.data import SynapseDataset
    from cswin_unet_tpu.eval import VolumeInferencer, inference
    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.utils.checkpoint import (
        detect_num_classes,
        find_checkpoint,
        flatten,
        load_checkpoint,
        merge_matching,
        unflatten,
    )
    from cswin_unet_tpu.utils.flops import count_flops_and_params

    random.seed(args.seed)
    np.random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    snapshot = find_checkpoint(args.model_path)
    if args.model_task_level:
        task_level = args.model_task_level
        model_num_classes = TASK_CLASSES[task_level]
    else:
        model_num_classes = detect_num_classes(snapshot)
        if model_num_classes not in CLASS_TO_TASK:
            raise RuntimeError(
                f"Unknown number of classes: {model_num_classes}. Expected 9, 12, or 14."
            )
        task_level = CLASS_TO_TASK[model_num_classes]
        print(f"Auto-detected model task level: {task_level}")

    mapping = CLASS_MAPPINGS[args.test_dataset]
    # XLA gathers clamp out-of-bounds indices silently, so an insufficient
    # task level would "evaluate" garbage — validate explicitly.
    if max(mapping["indices"]) >= model_num_classes:
        raise RuntimeError(
            f"Model task level {task_level} ({model_num_classes} classes) cannot "
            f"evaluate {args.test_dataset}, which needs output channels "
            f"{mapping['indices']}. Train the later continual stages first."
        )
    args.num_classes = mapping["classes"]
    args.list_dir = args.list_dir or LIST_DIRS[args.test_dataset]
    args.z_spacing = 1

    net = build_model(config, img_size=args.img_size, num_classes=model_num_classes)
    params = net.init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, args.img_size, args.img_size, 1))
    )
    loaded, _ = load_checkpoint(snapshot)
    params = unflatten(
        merge_matching(flatten(jax.device_get(params)), flatten(loaded), log=print)
    )
    print(f"Loaded model from: {snapshot}")
    print(f"Testing on {args.test_dataset} using classes at indices: {mapping['indices']}")

    logging.basicConfig(
        filename=os.path.join(args.output_dir, f"test_{args.test_dataset}.txt"),
        level=logging.INFO,
        format='[%(asctime)s.%(msecs)03d] %(message)s', datefmt='%H:%M:%S',
        force=True,
    )
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info(str(args))

    test_save_path = None
    if args.is_savenii:
        test_save_path = os.path.join(args.output_dir, "predictions")
        os.makedirs(test_save_path, exist_ok=True)

    db_test = SynapseDataset(base_dir=args.volume_path, split="test_vol",
                             list_dir=args.list_dir)
    # Channel gather happens on device inside the jitted forward
    # (ContinualTestWrapper equivalent, reference universal_test.py:50-54).
    inferencer = VolumeInferencer(
        net, params, patch_size=(args.img_size, args.img_size),
        class_indices=mapping["indices"] if task_level != "task1" or args.test_dataset != "synapse" else None,
    )
    inference(args, inferencer, db_test, test_save_path)

    try:
        flops, n_params = count_flops_and_params(net, params, args.img_size)
        print('FLOPs:', flops)
        print('Params:', n_params)
    except Exception as e:
        print(f"Could not calculate FLOPs/Params: {e}")
