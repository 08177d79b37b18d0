"""The program's own once-per-process set-up: the sum of the steps in
``svt_av1_tpu_torch.utils.trace.SETUP`` (the native and kernel builds and
loads, the table loads, ``Encoder.__init__``), read from the module this
process loaded. Nothing where the module has no such record."""

import sys


def read(run):
    mod = sys.modules.get("svt_av1_tpu_torch.utils.trace")
    setup = getattr(mod, "SETUP", None)
    if not setup:
        return None
    return sum(e["dur"] for e in setup)
