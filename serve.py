#!/usr/bin/env python
"""Serving CLI: segment CT volumes with a trained CSWin-UNet checkpoint.

The reference repo has no serving entry (its closest path is re-running
``test.py`` over a dataset, reference test.py:103-165). This is the
deployment surface:

  one-shot:  python serve.py --cfg C --checkpoint ck.npz vol1.npy.h5 vol2.npz
  watching:  python serve.py --cfg C --checkpoint ck.npz \
                 --watch incoming/ --output_dir out/

The batched slice forward compiles once at a fixed chunk shape and is warmed
before the first volume; each processed volume emits one JSON stats line on
stdout ({"case": ..., "slices_per_s": ...}). Watch mode moves inputs to
done/ (or failed/ with the error) so a filesystem queue composes directly.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cswin_unet_tpu.config import get_config

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument('volumes', nargs='*', help='volume files (.npy.h5/.npz/.npy)')
parser.add_argument('--cfg', type=str, required=True, metavar="FILE", help='path to config file')
parser.add_argument('--checkpoint', type=str, required=True,
                    help='model checkpoint (.npz or torch .pth)')
parser.add_argument('--output_dir', type=str, default='./served',
                    help='where predictions (<case>_pred.nii.gz) land')
parser.add_argument('--watch', type=str, default=None,
                    help='poll this directory for volumes instead of positional args')
parser.add_argument('--num_classes', type=int, default=9)
parser.add_argument('--img_size', type=int, default=224)
parser.add_argument('--batch_slices', type=int, default=32,
                    help='slices per compiled forward chunk')
parser.add_argument('--z_spacing', type=int, default=1)
parser.add_argument('--poll_s', type=float, default=1.0)
parser.add_argument('--max_volumes', type=int, default=None,
                    help='exit after N volumes (watch mode; default: run forever)')
parser.add_argument('--class_indices', type=int, nargs='+', default=None,
                    help='gather these output channels before argmax '
                         '(continual-learning task heads)')
parser.add_argument("--opts", default=None, nargs='+')
args = parser.parse_args()
config = get_config(args)


def main():
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.serve import VolumeServer, watch_loop
    from cswin_unet_tpu.utils.checkpoint import (
        flatten, load_checkpoint, merge_matching, unflatten)

    net = build_model(config, img_size=args.img_size,
                      num_classes=args.num_classes)
    params = net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, args.img_size, args.img_size, 1))
    )
    loaded, _ = load_checkpoint(args.checkpoint)
    params = unflatten(merge_matching(flatten(jax.device_get(params)),
                                      flatten(loaded)))

    server = VolumeServer(
        net, params, img_size=args.img_size, batch_slices=args.batch_slices,
        class_indices=args.class_indices, z_spacing=args.z_spacing,
    )
    warm_s = server.warmup()
    print(json.dumps({"ready": True, "warmup_s": round(warm_s, 2),
                      "checkpoint": args.checkpoint}), flush=True)

    if args.watch:
        n = watch_loop(server, args.watch, args.output_dir,
                       poll_s=args.poll_s, max_volumes=args.max_volumes,
                       emit=lambda s: print(s, flush=True))
        print(json.dumps({"drained": n}), flush=True)
        return

    if not args.volumes:
        parser.error("provide volume paths or --watch DIR")
    for path in args.volumes:
        stats = server.process_file(path, args.output_dir)
        print(json.dumps(stats), flush=True)


if __name__ == "__main__":
    main()
