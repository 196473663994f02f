"""aloam_tpu_torch — the PyTorch/CUDA port of aloam_tpu for NVIDIA Hopper.

The JAX package ``aloam_tpu`` is the reference; every module here has one
counterpart there, and the tests hold each against it. The port imports
``torch`` and numpy, never ``jax``. It reuses the JAX package's
framework-free modules as they are: ``aloam_tpu.config`` (``AloamConfig``,
``PRESETS``), ``aloam_tpu.io``, ``aloam_tpu.eval``,
``aloam_tpu.utils.tictoc`` and the JAX CLI's argument parser.

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

from aloam_tpu.config import AloamConfig, PRESETS  # noqa: F401
