"""The frozen reference (``benchmark/reference/aloam``) pinned to the f64
NumPy oracle of the whole odometry + mapping chain (``tests/oracle``),
which shares no code with it, the port or the JAX package: a fault in the
frozen copy's semantics, which the port's own tests could not see once it
was copied, moves its trajectory off the oracle's by centimetres to
metres. The scans are the benchmark's own traffic generator's, rendered
on the CPU; the capacities are sized to the scenes, so that a difference
means semantics, not truncation. The gate is the repo's oracle tests'
0.06 m on the odometry and mapped positions of every frame."""

import numpy as np
import pytest
import torch

from benchmark import render
from benchmark.reference.aloam import pipeline
from benchmark.reference.aloam.config import AloamConfig
from tests.oracle import pipeline as opipe

GATE_M = 0.06
YAW = {"rate": 0.0, "amplitude": 0.05, "period_s": 20.0}
CASES = {
    # 20 frames of the vlp16 cell's sensor at 512 steps a turn, 0.5 m/s,
    # the repo's oracle tests' scene class: at 2 m/s the JAX package
    # itself parts from the oracle by 0.09 m by frame 19 here, the
    # reference by 0.10 m, the two within 0.012 m of each other
    "vlp16": (dict(scan_lines=16, azimuth=512, noise=0.01, dropout=0.05),
              20, 0.5,
              AloamConfig(scan_lines=16, minimum_range=0.3,
                          line_resolution=0.2, plane_resolution=0.4,
                          n_raw=8192, ring_cap=640, less_flat_cap=8192,
                          map_table_corner=2048, map_table_surf=4096,
                          corner_stack_cap=1024, surf_stack_cap=4096)),
    # 3 frames of the hdl64 cell's sensor at 600 steps a turn, 5 m/s
    "hdl64": (dict(scan_lines=64, azimuth=600, noise=0.01, dropout=0.05),
              3, 5.0,
              AloamConfig(scan_lines=64, minimum_range=5.0,
                          line_resolution=0.4, plane_resolution=0.8,
                          n_raw=38400, ring_cap=1024, less_flat_cap=16384,
                          map_table_corner=4096, map_table_surf=8192,
                          corner_stack_cap=2048, surf_stack_cap=8192)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_trajectory_matches_the_f64_oracle(case):
    torch.set_num_threads(2)
    sensor, frames, speed, cfg = CASES[case]
    gen = torch.Generator().manual_seed(2**31 + 7)
    log = render.render_log(sensor, frames, speed, YAW, cfg.n_raw,
                            render.world_rng(2**31 + 7, 0), gen, "cpu")
    state = pipeline.init_state(cfg, 1, "cpu")
    t_odom, t_map, scans = [], [], []
    for xyz, mask in zip(log.xyz, log.mask):
        state, out = pipeline.step(state, xyz, mask, cfg)
        t_odom.append(out.t_odom.double().numpy())
        t_map.append(out.t_map.double().numpy())
        scans.append(xyz[mask].double().numpy())
    o_odom, o_map, _ = opipe.run_pipeline(
        scans, scan_lines=cfg.scan_lines, line_res=cfg.line_resolution,
        plane_res=cfg.plane_resolution, min_range=cfg.minimum_range)
    d_odom = np.linalg.norm(np.stack(t_odom) - o_odom, axis=1)
    d_map = np.linalg.norm(np.stack(t_map) - o_map, axis=1)
    assert d_odom.max() < GATE_M, d_odom
    assert d_map.max() < GATE_M, d_map
    # the scene moves the sensor: the comparison is not of two standstills
    assert np.linalg.norm(o_map[-1]) > 0.5 * speed * 0.1 * (frames - 1)
