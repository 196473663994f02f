"""The port's image (docker/Dockerfile.torch) against the working tree, as
tests/test_docker_contract.py holds the JAX package's image: every COPY
source exists, the ENTRYPOINT module resolves to the port's CLI, the
prebuild RUN names ``ops/_build.build`` and
``io/native_loader.load_library`` (both callable) and imports nothing
but the port, every flag of the default CMD is a flag of
``aloam_tpu_torch.cli.build_parser()``, and the CMD leaves the device at
the CLI's default (the card). Nothing is built, pulled or run here.
"""

import ast
import importlib.util
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCKERFILE = os.path.join(REPO, "docker", "Dockerfile.torch")


def _lines():
    with open(DOCKERFILE) as f:
        return [ln.strip() for ln in f if ln.strip()
                and not ln.strip().startswith("#")]


def _cmd_args():
    cmd = [ln for ln in _lines() if ln.startswith("CMD")]
    assert len(cmd) == 1, cmd
    return re.findall(r'"([^"]*)"', cmd[0])


def test_copy_sources_exist():
    copies = [ln for ln in _lines() if ln.startswith("COPY")]
    assert copies, "Dockerfile.torch has no COPY directives"
    srcs = [src for ln in copies for src in ln.split()[1:-1]]
    assert "aloam_tpu_torch" in srcs
    for src in srcs:
        assert os.path.exists(os.path.join(REPO, src)), \
            f"Dockerfile.torch COPY source missing from repo: {src}"


def test_entrypoint_is_the_port_cli():
    ep = [ln for ln in _lines() if ln.startswith("ENTRYPOINT")]
    assert len(ep) == 1 and '"-m"' in ep[0]
    mod = re.findall(r'"([\w\.]+)"', ep[0])[-1]
    assert mod == "aloam_tpu_torch.cli"
    assert importlib.util.find_spec(mod) is not None


def test_prebuild_hooks_exist():
    """The RUN step prebuilding the kernels and the native loader names
    real callables of the port."""
    runs = " ".join(ln for ln in _lines() if ln.startswith("RUN"))
    assert "_build.build()" in runs
    assert "native_loader.load_library()" in runs
    assert "aloam_tpu_torch" in runs
    from aloam_tpu_torch.io import native_loader
    from aloam_tpu_torch.ops import _build
    assert callable(_build.build) and callable(native_loader.load_library)


def test_prebuild_imports_only_the_port():
    """The prebuild's Python (each ``python -c``) parses and imports only
    the port: the image has no JAX and no ``aloam_tpu``."""
    codes = [c for ln in _lines() if ln.startswith("RUN")
             for c in re.findall(r'python -c "([^"]*)"', ln)]
    assert codes
    for code in codes:
        mods = [n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(ast.parse(code))
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names]
        assert mods and all(m.split(".")[0] == "aloam_tpu_torch"
                            for m in mods), mods


def test_default_cmd_flags_are_port_cli_flags():
    """Every --flag of the default CMD is one the port's CLI parser takes."""
    flags = [a for a in _cmd_args() if a.startswith("--")]
    assert flags
    from aloam_tpu_torch import cli
    known = {s for a in cli.build_parser()._actions  # noqa: SLF001
             for s in a.option_strings}
    for fl in flags:
        assert fl in known, f"Dockerfile.torch CMD flag unknown: {fl}"


def test_default_cmd_runs_on_the_card():
    """The CMD does not pass --device cpu: the image runs the CLI on its
    default device, the card."""
    args = _cmd_args()
    if "--device" in args:
        assert args[args.index("--device") + 1] != "cpu"
    assert not any(a.startswith("--device=cpu") for a in args)
    from aloam_tpu_torch import cli
    assert cli.build_parser().parse_args(args).device == "cuda"
