"""The whitening's device time a profiled step: the forward and backward
work under ``isw.whiten`` (every iw layer, its map's collection included)
and ``isw.loss`` (the whitening loss)."""

from benchmark import spans

WHITENING = {"isw.whiten", "isw.loss"}


def read(m):
    j = spans.joined(m)
    if j is None or not j.steps or not any(j.named(n) for n in WHITENING):
        return None
    return 1e3 * j.device_s(WHITENING) / len(j.steps)
