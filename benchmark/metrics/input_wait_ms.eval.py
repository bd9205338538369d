"""Device idle time a profiled image while the main thread was making the
evaluator's host batches (``eval.input``: the dataset's read, the stack
and its padding) or copying them (``h2d``)."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    if j is None or not m.profiled_images or not j.named("eval.input"):
        return None
    return 1e3 * j.idle_s({"eval.input", "h2d"}) / m.profiled_images
