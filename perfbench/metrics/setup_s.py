"""setup_s: seconds from the start of run.py to the first timed unit
(scene generation and build, warm-up, the first run's builds)."""


def read(run):
    return run.setup_s
