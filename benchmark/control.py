"""Readings for the limits of `correct`, at a cell's own size, several seeds
in one process (the benchmark's own runs never run this):

    python3 -m benchmark.control --workload <cell> --mode <mode> --seeds 1,2,3 --seconds 20

modes: `program` (the port as the cell runs it: the lower readings);
`ref-bf16` (the reference under bf16 autocast in the program's place, a
witness of what bf16 alone does); `control` and `control-int8` (the next
precision below the configuration's bf16: the reference computed in fp8, or
in int8, lowp.py, put in the program's place); `fault:<name>` (a fault of
faults.py planted under the timed path). Each seed prints one JSON line of
its readings; limits are not applied."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
from importlib import import_module

import torch

from .runners.train import Train
from .faults import STEP_FAULTS
from .harness import find_cell, one_thread
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
        model = reference_model(self.config, self.seed, self.device).train()
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    runner = import_module(f"benchmark.runners.{cell.traffic['kind']}")
    one_thread(torch)
    device = torch.device("cuda", 0)
    limits = limits_for(cell.name)
    for seed in (int(s) for s in args.seeds.split(",")):
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
        res = run.window(args.seconds)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        run.check(limits)
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "attempted": res["attempted"], "failed": res["failed"],
                          "metrics": res["metrics"], "readings": run.data["readings"],
                          "worst_leaf": run.data.get("worst_leaf")}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
