"""The pipeline and its ops: host launch calls (kernel launches, async
copies and memsets, CUDA graph launches) a call in the plain traced stretch."""


def read(run):
    if not run.stretches:
        return None
    s = run.stretches[0]
    return s.launches / s.calls
