"""Capture the inputs of the port's custom ops from outside the program: a
TorchDispatchMode that keeps the arguments of the first call of each op it
is asked for (`dfine_port::msda_fwd`, `dfine_port::msda_bwd`,
`dfine_port::stem_fwd`), so that a kernel's bound is counted on the very
tensors the timed path handed it."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from torch.utils._python_dispatch import TorchDispatchMode


class FirstCalls(TorchDispatchMode):
    """with FirstCalls(("msda_fwd", "msda_bwd")) as cap: ...;
    cap.args["msda_fwd"] is the first call's positional arguments."""

    def __init__(self, ops: Sequence[str], namespace: str = "dfine_port"):
        super().__init__()
        self.ops, self.namespace = tuple(ops), namespace
        self.args: Dict[str, Tuple[Any, ...]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, _, rest = func.name().partition("::")
        op = rest.split(".")[0]
        if ns == self.namespace and op in self.ops and op not in self.args:
            self.args[op] = tuple(args)
        return func(*args, **(kwargs or {}))
