"""The MSDA forward kernel's share of its roofline, %: the least seconds of
the work on the captured call's inputs (work.msda_work: each touched value
row once, loc, attn and out once; bytes at HBM bandwidth or operations at
the f32 peak) over the device seconds per launch of `msda_fwd_kernel`."""

import re

from benchmark.work import bound_s

KERNEL = re.compile(r"\bmsda_fwd_kernel\b")


def read(data):
    k, p = data.get("kernels", {}).get("msda_fwd"), data.get("profile")
    if not k or p is None:
        return None
    secs, n = p.kernel(KERNEL)
    return 100.0 * bound_s(k["bytes"], k["flops"], k["peak"]) / (secs / n) if n else None
