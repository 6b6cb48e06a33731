"""CUDA-graph replays of the window step per chunk delivered
(``core/scan.py``'s ``COUNTS["replays"]``): 1 where no flag cuts a
window, more where a cut window's later chunks run again.  Nothing to
read where no window runs."""


def read(run):
    replays = run.counters.get("scan.replays", 0.0)
    if run.chunks == 0 or replays == 0:
        return None
    return replays / run.chunks
