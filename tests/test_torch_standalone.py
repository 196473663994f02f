"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its own copies of the framework-free modules (config, io, eval, the
CLI's flags) give what the JAX package's give.

Every module of ``aloam_tpu_torch`` and ``chip_smoke.py`` is read as a
syntax tree, so an import inside a function counts as much as one at the
top. The copies are held to the originals on seeded inputs: configs field
by field, scenes array by array, trajectory metrics to 1e-12.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from aloam_tpu import cli as jcli
from aloam_tpu import config as jconfig
from aloam_tpu.eval import ate as jate
from aloam_tpu.io import synthetic as jsyn
from aloam_tpu_torch import cli
from aloam_tpu_torch import config
from aloam_tpu_torch.eval import ate
from aloam_tpu_torch.io import synthetic as syn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "aloam_tpu")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "aloam_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    """(line, module) of every import in the tree, function-level ones
    and ``importlib.import_module`` / ``__import__`` of a literal
    included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_never_imports_jax_or_the_jax_package():
    """An AST walk over every port module and chip_smoke.py: no import of
    ``jax`` or ``aloam_tpu`` anywhere, function-level imports included."""
    paths = _port_sources()
    assert len(paths) > 30
    bad = []
    for p in paths:
        with open(p) as fh:
            tree = ast.parse(fh.read(), filename=p)
        bad += [(os.path.relpath(p, REPO), line, mod)
                for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, bad


def test_import_walk_sees_function_level_imports():
    """The walk itself: it must catch the forms a port file could use."""
    code = ("def f():\n    import jax.numpy as jnp\n"
            "def g():\n    from aloam_tpu.config import PRESETS\n"
            "import importlib\nimportlib.import_module('aloam_tpu.io')\n"
            "from aloam_tpu_torch import config\n")
    found = [m for _, m in _imports(ast.parse(code)) if _forbidden(m)]
    assert found == ["jax.numpy", "aloam_tpu.config", "aloam_tpu.io"]


def _same_config(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("sharp_cap", "less_sharp_cap", "flat_cap", "region_cap",
                 "knn_radius"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_config_fields_match_jax():
    """The same fields in the same order, with the same defaults."""
    names = [f.name for f in dataclasses.fields(config.AloamConfig)]
    assert names == [f.name for f in dataclasses.fields(jconfig.AloamConfig)]
    _same_config(config.AloamConfig(), jconfig.AloamConfig())
    assert config._round_up(37, 8) == jconfig._round_up(37, 8) == 40


@pytest.mark.parametrize("preset", ["VLP-16", "HDL-32", "HDL-64"])
def test_presets_match_jax(preset):
    """Each preset field by field, derived caps included, and a replaced
    copy stays equal."""
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    _same_config(config.PRESETS[preset], jconfig.PRESETS[preset])
    _same_config(config.PRESETS[preset].replace(ring_cap=1856),
                 jconfig.PRESETS[preset].replace(ring_cap=1856))


@pytest.mark.parametrize("seed", [3, 11])
def test_synthetic_scenes_match_jax(seed):
    """make_sequence and pad_scan give the same arrays as JAX's."""
    kw = dict(scan_lines=16, n_azimuth=96, seed=seed, speed=4.0)
    scans, traj = syn.make_sequence(2, **kw)
    jscans, jtraj = jsyn.make_sequence(2, **kw)
    assert len(scans) == len(jscans) == 2
    for s, js in zip(scans, jscans):
        np.testing.assert_array_equal(s, js)
        for n_pad in (s.shape[0] - 7, s.shape[0] + 13):
            for a, b in zip(syn.pad_scan(s, n_pad), jsyn.pad_scan(js, n_pad)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(traj.trans, jtraj.trans)
    np.testing.assert_array_equal(traj.quats, jtraj.quats)


def _trajectories(seed, n=240):
    """A seeded ground truth (a winding drive, ~600 m) and an estimate
    with drift and noise, positions and wxyz quaternions."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0.0, 0.02, n))
    step = 2.5 + rng.uniform(0, 0.2, n)
    gt = np.cumsum(np.stack([step * np.cos(yaw), step * np.sin(yaw),
                             rng.normal(0, 0.01, n)], -1), axis=0)
    gq = np.stack([np.cos(yaw / 2), np.zeros(n), np.zeros(n),
                   np.sin(yaw / 2)], -1)
    est = gt * 1.002 + rng.normal(0, 0.05, (n, 3))
    eyaw = yaw + np.cumsum(rng.normal(0, 1e-3, n))
    eq = np.stack([np.cos(eyaw / 2), rng.normal(0, 1e-3, n),
                   rng.normal(0, 1e-3, n), np.sin(eyaw / 2)], -1)
    return est, gt, eq, gq


@pytest.mark.parametrize("seed", [0, 1])
def test_trajectory_metrics_match_jax(seed):
    """ate_rmse (aligned and not), rpe (with and without rotations, two
    spacings), rpe_rot and kitti_drift agree with JAX's to 1e-12."""
    est, gt, eq, gq = _trajectories(seed)
    for align in (True, False):
        assert abs(ate.ate_rmse(est, gt, align=align)
                   - jate.ate_rmse(est, gt, align=align)) <= 1e-12
    for delta in (1, 5):
        for q in ((None, None), (eq, gq)):
            a, ea = ate.rpe(est, gt, delta, *q)
            b, eb = jate.rpe(est, gt, delta, *q)
            assert abs(a - b) <= 1e-12
            np.testing.assert_allclose(ea, eb, rtol=0, atol=1e-12)
        a, ea = ate.rpe_rot(eq, gq, delta)
        b, eb = jate.rpe_rot(eq, gq, delta)
        assert abs(a - b) <= 1e-12
        np.testing.assert_allclose(ea, eb, rtol=0, atol=1e-12)
    for q in ({}, dict(est_q=eq, gt_q=gq)):
        (a, na), (b, nb) = ate.kitti_drift(est, gt, **q), \
            jate.kitti_drift(est, gt, **q)
        assert na == nb > 0 and abs(a - b) <= 1e-12


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     type(a).__name__, a.type)
            for a in parser._actions if a.dest != "help"}


def test_cli_parser_has_jax_flags_plus_device():
    """The port's parser: every flag of JAX's with the same option
    strings, default, choices, action and type, plus --device (cuda)."""
    mine, theirs = _flags(cli.build_parser()), _flags(jcli.build_parser())
    assert set(mine) == set(theirs) | {"device"}
    for dest, spec in theirs.items():
        assert mine[dest] == spec, dest
    assert mine["device"][:2] == (("--device",), "cuda")
    argv = ["--preset", "VLP-16", "--synthetic", "--frames", "3",
            "--skip-first", "1", "--out", "x"]
    a = vars(cli.build_parser().parse_args(argv))
    assert a.pop("device") == "cuda"
    assert a == vars(jcli.build_parser().parse_args(argv))
