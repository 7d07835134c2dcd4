"""What every cell shares: the spec and its files by name, the import check,
the device's description, the profiler's window and its
breakdown, and the result line. Runners (`runners/<kind>.py`) build the
program, open and close the window, and hold its outputs against the
reference; `run.py` strings them together."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (the port's name begins with the latter's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "custom_d_fine_tpu")


def forbidden_modules(names: Iterable[str], extra: Sequence[str] = ()) -> List[str]:
    """The top-level names among `names` (module names, dotted) that are
    FORBIDDEN or `extra`, compared whole."""
    bad = set(FORBIDDEN) | set(extra)
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in bad})


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]   # the spec's end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]    # the per-layer metrics this cell reports


def reports(metric: Dict[str, Any], cell: str, e2e_names: Sequence[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, spec: Optional[Dict[str, Any]] = None, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(root / conf["file"]), traffic_name=w["traffic"],
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def cell_from_files(config: Path, traffic: Path) -> Cell:
    """A one-chip cell that BENCHMARK.json does not list (yet): the
    configuration file and the traffic mix given by path, named
    <config>.<traffic> by their stems, with no metrics of its own. For
    readings taken before a cell is added (control.py)."""
    config, traffic = Path(config), Path(traffic)
    return Cell(name=f"{config.stem}.{traffic.stem}", chips=1, config_name=config.stem,
                config=load_json(config), traffic_name=traffic.stem,
                traffic=load_json(traffic), end_to_end=[], per_layer=[])


def load_reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """metrics/<metric>.py's `read(data) -> float or None`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ device

def one_thread(torch) -> None:
    """One host thread for PyTorch's CPU ops: the runs are host-bound, and
    pools of 8 threads on a shared 8-core host made set-up ~10 s longer and
    moved the step time of identical runs (PERF.md)."""
    torch.set_num_threads(1)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def device_block(torch, count: int) -> Dict[str, Any]:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


# ------------------------------------------------------------ profiler

@dataclass
class Profile:
    """One traced window: the device's events and the host's ops."""

    window_s: float
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # (name, start_ns, dur_ns)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    units: int = 0        # steps in the window

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, a, d in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], a + d)
            else:
                out.append([a, a + d])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel(self, pattern) -> Tuple[float, int]:
        """(device seconds, launches) of the events whose name matches."""
        hits = [d for n, _, d in self.device if pattern.search(n)]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, int] = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                      key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda e: e[1])
        labelled = []
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            covering = [(d, n) for n, a, d in host if a <= mid <= a + d]
            labelled.append([min(covering)[1] if covering else "host: no op recorded",
                             (g1 - g0) / 1e9])
        return {"device_ops": [[n[:160], d / 1e9] for n, d in ops], "idle_gaps": labelled}


def profile_window(torch, fn: Callable[[], int], device_index: int = 0) -> Profile:
    """Run fn (which returns the units it completed) under torch.profiler
    and return its device events and host ops; the window ends with a
    synchronize. Annotations that the profiler mirrors on the device's
    timeline are not device work and are left out."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out = Profile(window_s=window, units=units)
    for e in prof.profiler.kineto_results.events():
        if e.duration_ns() <= 0 or getattr(e, "is_user_annotation", lambda: False)():
            continue
        rec = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.device_index() in (device_index, -1):
                out.device.append(rec)
        elif e.device_type() == DeviceType.CPU:
            out.host.append(rec)
    return out


# ------------------------------------------------------------ result

@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only where every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def select_checks(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The readings that the cell's limits file compares, each with its
    limit; a reading without a limit is reported on standard error only."""
    missing = [k for k in limits if k not in readings]
    if missing:
        raise KeyError(f"limits for numbers this check does not read: {missing}")
    return [Check(k, float(readings[k]), float(limits[k])) for k in limits]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict[str, Any]],
                device: Dict[str, Any], checks: Sequence[Check],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                              "limit": c.limit} for c in checks}
    return json.dumps(out, allow_nan=False)


def print_checks(checks: Sequence[Check], file=sys.stderr) -> None:
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=file)
