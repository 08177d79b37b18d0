"""Process start to window start: imports, the first use's builds, the
stream's first frames, the card synchronised."""


def read(run):
    return run.setup_s
