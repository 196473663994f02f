"""aloam_tpu_torch — the PyTorch/CUDA port of aloam_tpu for NVIDIA Hopper.

The JAX package ``aloam_tpu`` is the reference; every module here has one
counterpart there, and the tests hold each against it. The port imports
only ``torch``, numpy and its own modules: never ``jax`` and nothing of
``aloam_tpu``. What it shares with the JAX package in content, it keeps as
its own copy: ``config`` (``AloamConfig``, ``PRESETS``), ``io`` (the
synthetic scenes, the KITTI reader and the native loader, whose C++ source
is ``native/kitti_loader.cpp``), ``eval`` (ATE, RPE, drift, plots),
``utils/tictoc.py`` and the CLI's flags.

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
under ``csrc/``, built for ``sm_90a`` at first use (``ops/_build.py``).
Each kernel's wrapper launches it for CUDA tensors and runs the plain
PyTorch version of the same function for CPU tensors.

Ported so far: the whole batched step (``pipeline.step_b``: scan
registration, feature extraction, scan-to-scan odometry and scan-to-map
mapping on the persistent voxel-hash map), the single-stream step with the
reference's exact per-round map search (``pipeline.step``), its
checkpoints (``utils/checkpoint.py``) and the CLI (``cli.py``).
"""

from aloam_tpu_torch.config import AloamConfig, PRESETS  # noqa: F401
