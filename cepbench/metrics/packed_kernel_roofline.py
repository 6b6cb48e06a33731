"""``packed_kernel``'s share of its roofline over the traced stretch:
the summed least times of its launches (``cepbench/roofline.py``'s
``packed_bound`` on each launch's own arguments) over its summed device
time in the profile.  The hook wraps ``repro_torch.kernels.ops.
window_join_packed_bits``, which the order engine calls through the
module; replays of a CUDA graph call no Python, so a window cell has
nothing to read."""

from cepbench.roofline import packed_counts, roofline

NAME = "packed_kernel"


def install(run):
    from repro_torch.kernels import ops

    calls = run.hooks.setdefault(NAME, [])
    inner = ops.window_join_packed_bits

    def wrapped(L, R, ops8, thetas, mvalid, bvalid, **kw):
        if L.is_cuda:
            calls.append(packed_counts(L, R, ops8, thetas, mvalid, bvalid))
        return inner(L, R, ops8, thetas, mvalid, bvalid, **kw)

    ops.window_join_packed_bits = wrapped

    def undo():
        ops.window_join_packed_bits = inner
    return undo


def read(run):
    calls = run.hooks.get(NAME)
    if run.trace is None or not calls:
        return None
    spent = run.trace.device_seconds(lambda n: NAME in n)
    if spent <= 0:
        return None
    least = sum(roofline(nbytes, float(ops))[0] for nbytes, ops in calls)
    return 100.0 * least / spent
