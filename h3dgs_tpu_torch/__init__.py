"""PyTorch/CUDA port of h3dgs_tpu for NVIDIA Hopper (H100).

The JAX package ``h3dgs_tpu`` is the reference this package is held
against; module names mirror it one for one, so each module's counterpart
is found under the same path there. This package imports ``torch`` and
numpy and never ``jax`` or ``h3dgs_tpu``: what it needs from the numpy-only
modules of the reference it keeps as its own copy.

Ported so far: the serving path (``.hier`` file -> ``HierarchyRenderer``
-> budget fit -> cut -> LOD interpolation -> projection -> binning ->
blend forward (CUDA kernel ``csrc/blend_fwd.cu``) -> uint8 frame ->
``viewer.service.serve``); coarse and per-chunk flat training
(``cli.train_coarse``, ``cli.train_single`` -> ``train.loop.train_flat``
-> the train step, with the blend backward ``csrc/blend_bwd.cu`` and the
fused SSIM loss ``csrc/ssim.cu``); hierarchy creation and post-training
(``cli.hierarchy_creator``, ``cli.train_post``); the merger
(``cli.hierarchy_merger``), evaluation (``cli.render_hierarchy``,
``eval.metrics``), the orchestrator (``cli.full_train``) and
preprocessing (``preprocess.drivers`` and its modules, with the image work
on the device in place of OpenCV). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
