"""cswin_unet_tpu — a JAX/XLA CSWin-UNet framework, run on NVIDIA GPUs.

A ground-up rebuild of the capabilities of BoloniniD/CSWin-UNet (a PyTorch/CUDA
research repo); README.md says where the package name comes from.

  * the compute path is pure JAX (functional, statically shaped, jit-compiled);
  * parallelism is a ``jax.sharding.Mesh`` + XLA collectives (replacing the
    reference's single-process ``nn.DataParallel``);
  * volume inference batches all slices of a CT volume into one device call
    (the reference runs batch-size-1 per slice);
  * checkpoints are ``.npz`` pytrees with the reference's checkpoint-surgery
    semantics (encoder→decoder mirroring, head expansion, prefix stripping).

Layer map (mirrors SURVEY.md §1 of the reference):
  config      -> cswin_unet_tpu.config
  model core  -> cswin_unet_tpu.models
  ops         -> cswin_unet_tpu.ops (XLA compositions)
  data        -> cswin_unet_tpu.data
  losses      -> cswin_unet_tpu.losses / metrics
  training    -> cswin_unet_tpu.train (base trainer, TPGM, surgical, continual)
  parallel    -> cswin_unet_tpu.parallel (mesh, shardings, collectives)
  eval        -> cswin_unet_tpu.eval (batched volume inference)
"""

__version__ = "0.1.0"
