"""Device time a profiled step of the work launched, on any thread, while
the program's ``train.backward`` span (``loss.backward()``) was open."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    if j is None or not j.steps:
        return None
    return 1e3 * j.launched_in("train.backward") / len(j.steps)
