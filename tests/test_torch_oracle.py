"""The port's full single-stream pipeline pinned to the f64 NumPy oracle.

The counterpart of tests/test_pipeline_oracle.py for ``aloam_tpu_torch``:
the same scenes and capacities, run through the port's ``pipeline.step``
on the CPU (every kernel's plain version), against the clean-room
double-precision oracle of the whole odometry + mapping chain
(tests/oracle/pipeline.py), which does not depend on JAX. The gate is the
JAX test's 0.06 m on the odometry and mapped positions of every frame: a
semantic break in any stage moves the trajectory by centimetres to
metres.

The oracle runs through ``run_pipeline`` directly; its cached wrapper
writes cache files and removes a checkpoint when a run ends.
"""

import numpy as np
import torch

from aloam_tpu_torch import pipeline
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.io import synthetic as syn
from tests.oracle import pipeline as opipe

torch.set_num_threads(1)

# tests/test_pipeline_oracle.py's capacities: sized to the scene, so that
# a difference means semantics, not truncation
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=16384, ring_cap=640, less_flat_cap=8192,
    map_table_corner=2048, map_table_surf=4096,
    corner_stack_cap=1024, surf_stack_cap=4096,
)
CFG64 = AloamConfig(
    scan_lines=64, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=65536, ring_cap=1024, less_flat_cap=16384,
    map_table_corner=4096, map_table_surf=8192,
    corner_stack_cap=2048, surf_stack_cap=8192,
)
GATE_M = 0.06


def _port_trajectory(scans, cfg):
    """t_odom, t_map (F, 3) of the port's single-stream step."""
    st = pipeline.init_state(cfg, 1, "cpu")
    t_odom, t_map = [], []
    for s in scans:
        xyz, mask = syn.pad_scan(s, cfg.n_raw)
        st, out = pipeline.step(st, torch.from_numpy(xyz),
                                torch.from_numpy(mask), cfg)
        t_odom.append(out.t_odom.numpy())
        t_map.append(out.t_map.numpy())
    return np.stack(t_odom), np.stack(t_map)


def _pin(scans, cfg):
    t_odom_o, t_map_o, _ = opipe.run_pipeline(
        list(scans), scan_lines=cfg.scan_lines,
        line_res=cfg.line_resolution, plane_res=cfg.plane_resolution,
        min_range=cfg.minimum_range)
    t_odom_e, t_map_e = _port_trajectory(scans, cfg)
    d_odom = np.linalg.norm(t_odom_e - t_odom_o, axis=1)
    d_map = np.linalg.norm(t_map_e - t_map_o, axis=1)
    assert d_odom.max() < GATE_M, (d_odom, t_odom_e, t_odom_o)
    assert d_map.max() < GATE_M, (d_map, t_map_e, t_map_o)
    return d_odom, d_map


def test_port_trajectory_matches_full_oracle():
    """20 frames of the 16-line scene (seed 3, 0.5 m/s, 512 azimuth
    steps)."""
    scans, _ = syn.make_sequence(20, scan_lines=16, n_azimuth=512, seed=3,
                                 speed=0.5)
    _pin(scans, CFG)


def test_port_trajectory_matches_full_oracle_hdl64():
    """2 frames of the 64-line scene (seed 5, 0.5 m/s, 900 azimuth
    steps): the upper/lower-bank ring formulas and the 6-region windows
    at real ring widths."""
    scans, _ = syn.make_sequence(2, scan_lines=64, n_azimuth=900, seed=5,
                                 speed=0.5)
    _pin(scans, CFG64)
