"""Run one cell of the benchmark once, on the card:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); ``benchmark/workloads/<cell>.json``
holds the check's sample sizes and limits. The run renders the traffic's
logs on the card from the seed, warms the program's step up, measures for
``--seconds``, checks the outputs against the plain reference, and prints
one JSON line last on standard output, after the numbers compared, each
beside its limit, on standard error. ``--trace 1`` reports the per-layer
metrics instead of the end-to-end ones.

``--control`` (never in a benchmark run) also puts the reference, computed
in bfloat16, in the program's place and prints its numbers. ``--calibrate
N`` runs N seeds from ``--seed`` on in one process and prints one JSON line
a seed with the numbers compared (and the control's, with ``--control``):
the readings that the limits in ``benchmark/workloads/<cell>.json`` are set
from, and the tool to set a new cell's limits with.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "aloam_tpu")


def load_cell(name: str, root: Path = ROOT):
    """(the manifest, its cell entry, a ``harness.Cell``)."""
    from benchmark.harness import Cell
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def data(*parts):
        return json.loads(root.joinpath("benchmark", *parts).read_text())
    cell = Cell(name, data("configs", entry["config"] + ".json"),
                data("traffic", entry["traffic"] + ".json"),
                data("workloads", name + ".json"))
    return manifest, entry, cell


def cell_metrics(manifest: dict, name: str, kind: str) -> list:
    """The names of the cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m["name"] for m in manifest[kind]
            if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _say(*parts) -> None:
    print("[run]", *parts, file=sys.stderr, flush=True)


def render(cell, seed: int, device):
    from benchmark.render import render_pool
    traffic = dict(cell.traffic, frames=cell.config["log_frames"])
    return render_pool(cell.config["sensor"], traffic,
                       cell.config["aloam"]["n_raw"], seed, device)


def ate(prog, window, gt) -> list:
    """Each stream's unaligned ATE (m) over the window's frames, its mapped
    positions against the ground truth of the log it played."""
    import numpy as np
    err = [[] for _ in range(prog.streams)]
    for (p, f), pose in zip(window.schedule, window.poses):
        for b, log in enumerate(prog.logs_of(p)):
            err[b].append(np.sum((pose[b, 4:] - gt[log, f]) ** 2))
    return [float(np.sqrt(np.mean(e))) for e in err]


def run_cell(manifest, cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False,
             window_frames: int | None = None):
    """One run: (the result's JSON object, the numbers compared, the
    control's numbers or None). ``window_frames`` (the CPU rehearsal) sets
    the window by frames instead of seconds."""
    import numpy as np
    import torch

    from benchmark import check, roofline
    from benchmark import trace as tr
    from benchmark.harness import Program, drive, warm_up

    t_ready = time.perf_counter()
    xyz, mask, gt = render(cell, seed, device)
    prog = Program(cell, xyz, mask, device)
    t_render = time.perf_counter()
    warm_up(prog)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    win = drive(prog, seconds, n_frames=window_frames)
    setup_s = win.t0 - t_start
    _say(f"setup_s {setup_s!r}: start to the card ready "
         f"{t_ready - t_start!r}, rendering {t_render - t_ready!r}, "
         f"warm-up {t_warm - t_render!r}")
    b = prog.streams
    n_scans = len(win.schedule) * b
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    if prog.path == "fleet":
        metrics["scans_per_s"] = {"value": n_scans / win.seconds,
                                  "unit": "scans/s"}
    else:
        lat = win.scan_ms
        metrics["scan_ms_p99"] = {"value": float(np.percentile(lat, 99)),
                                  "unit": "ms"}
        _say("scan_ms " + ", ".join(
            f"p{q} {float(np.percentile(lat, q))!r}"
            for q in (50, 90, 95, 99, 99.5)) + f" over {len(lat)} scans, "
            f"{float((lat > np.median(lat) + 0.5).mean())!r} of them over "
            f"the median + 0.5 ms; host-clock issue ms mean "
            f"{float(win.issue_ms.mean())!r}")
    _say(f"window {win.seconds!r} s, {len(win.schedule)} frames x {b} "
         f"streams, passes {win.schedule[0][0]}..{win.schedule[-1][0]}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ates = ate(prog, win, gt)
    _say(f"ATE m (unaligned, mapped) max {max(ates)!r} median "
         f"{float(np.median(ates))!r}")

    record = None
    if trace:
        x, m = prog.frame(*win.next)
        work = tr.record_work(prog, win.state, x, m)
        kernels = roofline.load_kernels()
        n_tr = cell.check["trace_frames"]
        stretch, events = tr.profiled(lambda: drive(
            prog, 0.0, start=win.next, n_frames=n_tr, state=win.state))
        red = tr.reduce_events(events, kernels)
        del events
        record = dict(path=prog.path, issue_ms=win.issue_ms,
                      frames_traced=n_tr, window_s=stretch.seconds,
                      frame_s=win.seconds / len(win.schedule),
                      kernel_work=work, **red)
        shares = tr.kernel_shares(record)
        _say("kernel roofline % " + ", ".join(
            f"{k} {v!r} ({work[k][1]} launches a frame)"
            for k, v in shares.items()))
        _say(f"traced {n_tr} frames in {stretch.seconds!r} s, busy "
             f"{red['busy_s']!r} s")
        for name, sec in red["device_ops"]:
            _say(f"device op {sec * 1e3 / n_tr!r} ms a frame: {name}")
        for name, sec in red["idle_gaps"]:
            _say(f"idle {sec * 1e3 / n_tr!r} ms a frame under: {name}")

    # the program's state goes before the reference runs
    prog.step = None
    win = win._replace(state=None)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    from benchmark.reference.aloam.pipeline import METRIC_NAMES
    rcfg = check.ref_config(cell.config)
    replay = check.choose(cell, prog, win, seed)
    t_ref = time.perf_counter()
    numbers = check.compare(prog, win, replay, rcfg, METRIC_NAMES)
    _say(f"reference {time.perf_counter() - t_ref!r} s: pass "
         f"{replay.pass_}, streams {replay.streams}, frames 0-"
         f"{replay.frames - 1}")
    limits = cell.check["limits"]
    if control:
        t_ref = time.perf_counter()
        ctl = check.compare(prog, win, replay, rcfg, METRIC_NAMES,
                            control=True)
        _say(f"control {time.perf_counter() - t_ref!r} s: "
             + json.dumps(ctl))
    # a scan whose pose never reached the host, or came back not finite,
    # failed
    failed = n_scans - int(np.isfinite(win.poses).all(-1).sum())
    correct = failed == 0 and check.verdict(numbers, limits)
    result = {"correct": correct, "attempted": n_scans, "failed": failed}
    if trace:
        names = cell_metrics(manifest, cell.name, "per_layer")
        result["metrics"] = {
            n: {"value": v, "unit": _unit(manifest, n)}
            for n, v in tr.read_metrics(names, record).items()}
    else:
        names = cell_metrics(manifest, cell.name, "end_to_end")
        result["metrics"] = {n: metrics[n] for n in names}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=record["busy_s"],
                                window_s=record["window_s"])
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                        for n in check.NUMBERS}
    return result, numbers, (ctl if control else None)


def _unit(manifest, name):
    return next(m["unit"] for m in manifest["per_layer"]
                if m["name"] == name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the control (the reference in "
                    "bfloat16); never in a benchmark run")
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="read the numbers compared on N seeds from --seed "
                    "on, in one process, one JSON line a seed")
    args = ap.parse_args(argv)
    # caches of the program and of torch stay inside the checkout
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_build"
                                                  / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_build"
                                                      / "torch_extensions"))
    manifest, entry, cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"[run] {args.workload} needs {entry['chips']} CUDA card(s), "
              f"{found} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    if args.calibrate:
        return calibrate(manifest, cell, args, device)
    result, numbers, _ = run_cell(manifest, cell, args.seed, args.seconds,
                                  bool(args.trace), device, T_START,
                                  control=args.control)
    found = forbidden_modules()
    if found:
        print(f"[run] the run loaded {found}: the port may load no JAX "
              f"and nothing of the JAX package", file=sys.stderr)
        return 3
    from benchmark import check
    check.say(numbers, cell.check["limits"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def calibrate(manifest, cell, args, device) -> int:
    """The program's numbers (and with ``--control`` the control's) on
    ``--calibrate`` seeds, one process: one JSON line a seed."""
    import gc

    import torch
    for i in range(args.calibrate):
        seed = args.seed + i
        t0 = time.perf_counter()
        res, numbers, ctl = run_cell(manifest, cell, seed, args.seconds,
                                     False, device, t0,
                                     control=args.control)
        print(json.dumps({"seed": seed, "program": numbers, "control": ctl,
                          "metrics": res["metrics"]}), flush=True)
        gc.collect()            # the seed's program, graphs and logs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
