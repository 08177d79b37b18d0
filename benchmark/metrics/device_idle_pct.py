"""100 minus the union of the device's operation intervals over the
profiled frame's wall, from torch.profiler."""


def read(run):
    prof = run.profile
    if not prof.get("busy_s") or not prof.get("wall_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
