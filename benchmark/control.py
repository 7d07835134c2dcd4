"""Readings for the limits of `correct`, at a cell's own size, several seeds
in one process (the benchmark's own runs never run this):

    python3 -m benchmark.control --workload <cell> --mode <mode> --seeds 1,2,3 --seconds 20
    python3 -m benchmark.control --config <file> --traffic <file> --mode <mode> --seeds 1,2,3

The second form takes a configuration file and a traffic mix that
BENCHMARK.json does not list yet (the cell <config>.<traffic>, one chip), so
that a configuration's readings can be taken before its cell exists.

modes: `program` (the port as the cell runs it: the lower readings);
`ref-bf16` (the reference under bf16 autocast in the program's place, a
witness of what bf16 alone does); `control` and `control-int8` (the next
precision below the configuration's bf16: the reference computed in fp8, or
in int8, lowp.py, put in the program's place); `fault:<name>` (a fault of
faults.py planted under the timed path). Each seed prints one JSON line of
its readings, the seconds of its set-up, window and check, the device's
memory peak during the program and during the check (the reference), the
program's CUDA-graph counters (`step.graphs.front` and `.loss`: units
replayed, captured and run eagerly; null where the step has none), and
with --profile the device ms of a program step (the busy time of a profiled
window of 3 steps); limits are not applied. Exits 2 without a card."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from importlib import import_module

import torch

from .runners.train import Train
from .faults import STEP_FAULTS
from .harness import ROOT, cell_from_files, find_cell, one_thread, profile_window
from .run import limits_for


class TrainControl(Train):
    """The training runner with the reference in the program's place,
    computed in fp8 (the control) or, as a witness, under bf16 autocast as
    the port's step runs (mode `ref-bf16`)."""

    precision = "fp8"

    def matcher_module(self):
        from .reference.dfine.train import matcher

        return matcher

    def build(self):
        from .runners.common import model_config, reference_model
        from .lowp import Fp8Compute, Int8Compute, fp8_round, int8_round, round_leaf_outputs
        from .reference.dfine.train.criterion import DFINECriterion
        from .reference.dfine.train.optim import Optimizer
        from .reference.dfine.train.train_step import RefState, train_step

        cfg = model_config(self.config)
        criterion = DFINECriterion(cfg.criterion, cfg.matcher,
                                   num_classes=self.config["num_classes"])
        model = reference_model(self.config, self.seed, self.device, self.mix["img"]).train()
        state = RefState(model, Optimizer(model, cfg, **self._opt_kw()),
                         {k: v.detach().clone() for k, v in model.state_dict().items()})

        if self.precision in ("fp8", "int8"):
            round_leaf_outputs(model, fp8_round if self.precision == "fp8" else int8_round)
        forward = model.forward

        def low_forward(*args, **kwargs):  # the region the program autocasts
            mode = {"fp8": Fp8Compute, "int8": Int8Compute}.get(
                self.precision, lambda: torch.autocast("cuda", dtype=torch.bfloat16))()
            with mode:
                return forward(*args, **kwargs)

        model.forward = low_forward

        def step(state, batch, gen):
            return state, train_step(state, criterion, batch, gen)

        return step, state


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = p.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload", help="a cell of BENCHMARK.json")
    which.add_argument("--config", help="a configuration file (with --traffic)")
    p.add_argument("--traffic", help="a traffic mix file (with --config)")
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--profile", action="store_true",
                   help="program mode: the device ms of a step from a profiled window")
    args = p.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        p.error("--config and --traffic go together")
    mode = args.mode.split(":", 1)
    if args.mode not in ("program", "control", "control-int8", "ref-bf16") and not (
            mode[0] == "fault" and len(mode) == 2 and mode[1] in STEP_FAULTS):
        p.error(f"--mode {args.mode!r}: program, control, control-int8, ref-bf16 or "
                f"fault:<{'|'.join(STEP_FAULTS)}>")
    return args


def graph_counters(step):
    """The per-site counters of the port's step function, or None (the
    reference in the program's place, a fault's wrapper)."""
    graphs = getattr(step, "graphs", None)
    if graphs is None:
        return None
    return {site: {k: getattr(getattr(graphs, site), k) for k in ("replays", "captures", "eager")}
            for site in ("front", "loss")}


def cell_of(args):
    """The cell named by --workload, or made from --config and --traffic,
    with the limits of its cell where BENCHMARK.json has one."""
    if args.workload is not None:
        cell = find_cell(args.workload)
        return cell, limits_for(cell.name)
    cell = cell_from_files(args.config, args.traffic)
    listed = (ROOT / "benchmark" / "limits" / f"{cell.name}.json").is_file()
    return cell, limits_for(cell.name) if listed else {}


def main(argv=None) -> int:
    args = parse(argv)
    cell, limits = cell_of(args)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    runner = import_module(f"benchmark.runners.{cell.traffic['kind']}")
    one_thread(torch)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kw = {}
        if args.mode.startswith("fault:"):
            kw["step_wrapper"] = STEP_FAULTS[args.mode.split(":", 1)[1]]
        if args.mode in ("control", "control-int8", "ref-bf16"):
            run = TrainControl(cell, seed, device)
            run.precision = {"control": "fp8", "control-int8": "int8"}.get(args.mode, "bf16")
        else:
            run = runner.make(cell, seed, device, **kw)
        with tempfile.TemporaryDirectory(prefix="dfine_bench_") as tmp:
            run.setup(tmp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = run.window(args.seconds)
        t2 = time.perf_counter()
        step_ms = None
        if args.profile:
            def three_steps() -> int:
                for _ in range(3):
                    run._one()
                return 3

            prof = profile_window(torch, three_steps)
            step_ms = prof.busy_s() / prof.units * 1e3
        peak_program = torch.cuda.max_memory_allocated()
        graphs = graph_counters(run.step)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t3 = time.perf_counter()
        run.check(limits)
        torch.cuda.synchronize()
        seconds = {"setup": t1 - t0, "window": t2 - t1, "check": time.perf_counter() - t3}
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "attempted": res["attempted"], "failed": res["failed"],
                          "metrics": res["metrics"], "readings": run.data["readings"],
                          "worst_leaf": run.data.get("worst_leaf"), "seconds": seconds,
                          "peak_bytes": {"program": peak_program,
                                         "check": torch.cuda.max_memory_allocated()},
                          "graphs": graphs, "device_step_ms": step_ms}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
