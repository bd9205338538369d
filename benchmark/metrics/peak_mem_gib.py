"""``torch.cuda.max_memory_allocated()`` over the run, set-up included."""


def read(m):
    return m.peak_bytes / 2 ** 30 if m.peak_bytes else None
