"""The MSDA backward's share of its roofline, %: the least seconds of the
work on the captured call's inputs (work.msda_bwd_work) over the device
seconds per launch of `msda_bwd_dvalue_kernel` + `msda_bwd_dloc_kernel`
(one launch of the op runs one of each)."""

import re

from benchmark.work import bound_s

KERNELS = re.compile(r"\bmsda_bwd_(dvalue|dloc)_kernel\b")
LAUNCH = re.compile(r"\bmsda_bwd_dvalue_kernel\b")


def read(data):
    k, p = data.get("kernels", {}).get("msda_bwd"), data.get("profile")
    if not k or p is None:
        return None
    secs, _ = p.kernel(KERNELS)
    _, n = p.kernel(LAUNCH)
    return 100.0 * bound_s(k["bytes"], k["flops"], k["peak"]) / (secs / n) if n else None
