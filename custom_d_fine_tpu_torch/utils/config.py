"""YAML experiment config with ${...} interpolation + dotted CLI overrides.

Stands in for the reference's hydra/omegaconf stack (config.yaml:152-162,
CLI overrides like `python -m src.dl.train exp_name=x`): supports nested
interpolation (`${train.lrs.${model_name}.base_lr}`), `${now_dir}` date
stamping, and `key.sub=value` command-line overrides. The port's copy of
custom_d_fine_tpu/utils/config.py; PyYAML is imported where a file or an
override is parsed, so the Trainer itself (which takes a plain dict) needs
none.
"""

from __future__ import annotations

import datetime
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

_INTERP = re.compile(r"\$\{([^${}]+)\}")

DEFAULT_CONFIG = Path(__file__).parent.parent / "configs" / "config.yaml"


class Config(dict):
    """Dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _lookup(root: Dict, dotted: str):
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"interpolation key not found: {dotted}")
    return node


def _resolve_str(s: str, root: Dict, depth: int = 0):
    if depth > 10:
        raise ValueError(f"interpolation too deep: {s}")
    while True:
        m = _INTERP.search(s)
        if not m:
            return s
        val = _lookup(root, m.group(1))
        if isinstance(val, str) and "${" in val:
            val = _resolve_str(val, root, depth + 1)
        if m.span() == (0, len(s)):
            return val  # full-string interpolation keeps the value's type
        s = s[: m.start()] + str(val) + s[m.end():]


def _resolve(node: Any, root: Dict):
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str) and "${" in node:
        return _resolve_str(node, root)
    return node


def _parse_value(s: str):
    import yaml

    try:
        return yaml.safe_load(s)
    except Exception:
        return s


def apply_overrides(cfg: Dict, overrides: List[str]) -> None:
    """`a.b.c=value` assignments (hydra CLI parity)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Config:
    import yaml

    path = Path(path) if path else DEFAULT_CONFIG
    raw = yaml.safe_load(path.read_text())
    raw.setdefault("now_dir", datetime.date.today().isoformat())
    if overrides:
        apply_overrides(raw, overrides)
    resolved = _resolve(raw, raw)
    # second pass: overrides may reference interpolations and vice versa
    resolved = _resolve(resolved, resolved)
    return Config(resolved)


def resolve_experiment_dir(path_to_save: str) -> str:
    """Latest-experiment resolution (reference dl/utils.py:789-806).

    Run dirs are named `exp_name_YYYY-MM-DD` via the `${now_dir}` interpolation,
    so export/bench/infer invoked on a later day would point at a nonexistent
    directory. If `path_to_save` doesn't exist, resolve to the most recently
    modified sibling sharing the same experiment-name prefix.
    """
    p = Path(path_to_save)
    if p.exists() or not p.parent.exists():
        return str(p)
    m = re.match(r"(.+)_\d{4}-\d{2}-\d{2}$", p.name)
    prefix = (m.group(1) if m else p.name) + "_"
    cands = sorted(
        (d for d in p.parent.iterdir() if d.is_dir() and d.name.startswith(prefix)),
        key=lambda d: d.stat().st_mtime,
    )
    return str(cands[-1]) if cands else str(p)
