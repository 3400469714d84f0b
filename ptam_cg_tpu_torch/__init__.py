"""PyTorch + CUDA port of ``ptam_cg_tpu``: tracking (``models.tracker``),
keyframe integration and the mapping jobs (``models.keyframe``,
``models.mapmaker``), bundle adjustment (``models.bundle``), stereo init
(``models.homography``, ``models.initializer``), relocalization
(``models.relocalizer``), the engine with or without its mapping thread
(``models.engine``), and the dataset entry point around it (``io.tum``,
``io.settings``, ``native``, ``io.checkpoint``, ``io.commands``, ``viz``;
``python -m ptam_cg_tpu_torch.apps.run_tum``).

The layout mirrors the JAX package module by module; ``kernels/`` and
``csrc/`` hold the hand-written Hopper kernels and their plain PyTorch
versions. ``config.py`` is the port's own copy of the JAX package's
tunables, held equal to it by a test. Importing this package imports
``torch`` and numpy, and nothing of ``jax`` or of ``ptam_cg_tpu``.
Entry points that make tensors put them on the card unless the caller
passes ``device="cpu"``.
"""
