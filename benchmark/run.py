"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
finds the cell in BENCHMARK.json, its configuration under
benchmark/configs/, its traffic under benchmark/traffic/ (whose `driver`
names the generator that runs it) and each per-layer metric's reader under
benchmark/metrics/; sets up, warms up, measures for --seconds, checks the
outputs against the plain reference and prints one JSON line last on
standard output. Without CUDA, or with fewer cards than the cell asks for,
it exits nonzero and prints no result. A traffic file's `driver` is the
name of a module under benchmark/drivers/, found by that name alone.

Builder's modes, not run by the checks:
  --rehearse            the cell's control flow at tiny sizes on the CPU
                        (its numbers are not the device's);
  --calibrate S1,S2,..  the check's numbers of the program and of the
                        control (the reference in float8) on each seed;
  --sweep R1,R2,..      open-loop windows at each rate (drivers that sweep);
  --add-cells FILE      also the cells of a fragment of BENCHMARK.json
                        (benchmark/pending/: cells not in the benchmark).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

DRIVERS = os.path.join(harness.BENCH_DIR, "drivers")


def _driver(cell: harness.Cell):
    """The module benchmark/drivers/<driver>.py that the cell's traffic
    names. A driver provides `run(cell, seed, seconds, trace, rehearse)`,
    and may provide `calibrate(cell, seeds, seconds)` and `sweep(cell,
    seed, seconds, rates)`."""
    name = cell.traffic["driver"]
    if not isinstance(name, str) or not re.fullmatch(r"[a-z0-9_]+", name) or \
            not os.path.isfile(os.path.join(DRIVERS, name + ".py")):
        present = sorted(f[:-3] for f in os.listdir(DRIVERS)
                         if f.endswith(".py") and f != "__init__.py")
        raise LookupError(f"traffic of {cell.name!r} names an unknown driver {name!r}; "
                          f"modules under benchmark/drivers/: {present}")
    driver = importlib.import_module(f"benchmark.drivers.{name}")
    if not callable(getattr(driver, "run", None)):
        raise LookupError(f"benchmark/drivers/{name}.py, named by {cell.name!r}, has no run()")
    return driver


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rehearse", action="store_true")
    parser.add_argument("--calibrate", default=None)
    parser.add_argument("--sweep", default=None)
    parser.add_argument("--add-cells", default=None)
    args = parser.parse_args(argv)
    try:
        cell = harness.Cell(harness.load_spec(args.add_cells), args.workload)
        driver = _driver(cell)
    except (LookupError, OSError) as e:
        harness.log(f"cannot run {args.workload!r}: {e}")
        return 2
    for mode in ("calibrate", "sweep"):
        if getattr(args, mode) and not hasattr(driver, mode):
            harness.log(f"cannot --{mode} {args.workload!r}: its driver "
                        f"{cell.traffic['driver']!r} has no {mode}()")
            return 2
    harness.set_cache_env()
    if not args.rehearse:
        harness.require_cards(cell.chips)
        harness.log(f"card: {harness.card_line()}")
    if args.calibrate:
        rows = driver.calibrate(cell, [int(s) for s in args.calibrate.split(",")], args.seconds)
        print(json.dumps({"calibration": rows}), flush=True)
        return 0
    if args.sweep:
        rows = driver.sweep(cell, args.seed, args.seconds,
                            [float(r) for r in args.sweep.split(",")])
        print(json.dumps({"sweep": rows}), flush=True)
        return 0
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), args.rehearse)
    if args.rehearse:  # no device number from a CPU run
        device_only = {m["name"] for m in cell.per_layer
                       if m["source"] == "device_trace" or "mfu" in m["name"]}
        result["metrics"] = {k: v for k, v in result["metrics"].items() if k not in device_only}
        result["rehearsal"] = True
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
