"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the program, making the inputs and weights from the seed,
warming every shape the traffic uses) runs first and is `setup_s`, from the
process's start to the opening of the window. The window measures for
--seconds. With --trace 1 the run reads the cell's per-layer metrics
instead: the same window untraced (host timings), then a profiled window, and
the kernels' inputs captured. Then the device's memory peak is read, the
program's state is freed, and the plain reference decides `correct`. The
last lines of standard error give each number compared beside its limit;
the last line of standard output is the result (JSON).

Exit codes: 0 with a result; 2 without a card (or fewer than the cell asks
for); 3 when a forbidden module (JAX or the JAX package) was loaded; 1 on
any other failure. Caches of the program's builds stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as near as Python can see it

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from importlib import import_module  # noqa: E402

from .harness import (ROOT, device_block, find_cell, forbidden_modules,  # noqa: E402
                      load_json, load_reader, one_thread, power_limit, print_checks,
                      result_line)

CACHE = ROOT / ".bench_cache"  # fixed paths inside the checkout: only a first run builds


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limits_for(cell: str):
    return load_json(ROOT / "benchmark" / "limits" / f"{cell}.json")["limits"]


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(CACHE / sub))
    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    one_thread(torch)
    runner = import_module(f"benchmark.runners.{cell.traffic['kind']}")
    limits = limits_for(cell.name)
    torch.cuda.reset_peak_memory_stats()
    run = runner.make(cell, args.seed, torch.device("cuda", 0))
    with tempfile.TemporaryDirectory(prefix="dfine_bench_") as tmp:
        run.setup(tmp)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"setup_s {setup_s:.3f}", file=sys.stderr)
    res = run.window(args.seconds)
    print(f"window: {res}", file=sys.stderr)
    if args.trace:
        run.traced()
    device = device_block(torch, cell.chips)
    run.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks = run.check(limits)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    breakdown = None
    if args.trace:
        data = dict(run.data, power=power_limit())
        prof = data.get("profile")
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if prof is not None and prof.device:
            device["busy_s"] = prof.busy_s()
            device["window_s"] = prof.window_s
            breakdown = prof.breakdown()
        print(f"peaks (FLOP/s): bf16 {run_peaks()}; card: {data['power']}", file=sys.stderr)
    else:
        metrics = dict(res["metrics"])
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for err in run.data.get("errors", [])[:5]:
        print(f"failed: {err}", file=sys.stderr)
    compared = {c.name for c in checks}
    for k, v in run.data.get("readings", {}).items():
        if k not in compared:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    correct = all(c.ok for c in checks)
    print_checks(checks)
    print(result_line(correct, res["attempted"], res["failed"], metrics, device, checks,
                      breakdown))
    return 0


def run_peaks() -> str:
    from . import work

    return (f"{work.PEAK_BF16:.4g}, tf32 {work.PEAK_TF32:.4g}, f32 {work.PEAK_F32:.4g}; "
            f"bytes/s {work.PEAK_BYTES:.4g}")


if __name__ == "__main__":
    sys.exit(main())
