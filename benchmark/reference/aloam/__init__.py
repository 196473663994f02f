"""A frozen copy of ``aloam_tpu_torch``'s step in plain PyTorch: the
benchmark's reference.

Copied module for module from the port's tree at the commit that added the
benchmark (``pipeline``: ``init_state``, ``step_b``, ``step``; ``odometry``,
``mapping``, ``neighbors``, ``solver``, ``geometry``, ``frontend/``,
``ops/``, ``utils/``, ``config``, ``types``), with every CUDA kernel taken
out: each entry point of ``ops/`` runs its plain PyTorch version on any
device. It imports nothing of the port, so a later change to the port is
held against this copy, never against itself. Its outputs are the port's
own plain path's at that commit, which the port's tests held against the
JAX package and the f64 oracle.
"""
