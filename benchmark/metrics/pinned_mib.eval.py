"""MiB an image pinned on the fly in the profiled sweep: the ``pinned``
bytes of its ``h2d`` spans (a pageable source copied into pinned memory
before its copy to the card), over the profiled images."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    copies = [] if j is None else j.named("h2d")
    if not copies or not m.profiled_images:
        return None
    return sum(s.counts.get("pinned", 0) for s in copies) / m.profiled_images / 2 ** 20
