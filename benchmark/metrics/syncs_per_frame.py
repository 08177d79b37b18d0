"""Host-device synchronisations on the main thread per coded frame: the
``syncs`` the program counts on each span (torch's sync debug mode, each
synchronising CUDA call on the innermost open span), summed over the
window's ``MainThread`` spans, over the frames its ``keyframe`` and
``inter_frame`` spans coded. Nothing where no span carries the count."""


def read(run):
    frames = run.spans_named("keyframe", "inter_frame")
    counted = [s for s in run.spans or () if "syncs" in s
               and s.get("thread") == "MainThread"]
    if not frames or not counted:
        return None
    return sum(s["syncs"] for s in counted) / len(frames)
