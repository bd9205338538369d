"""NP+'s device time in a step whose NP+ gate fired: the mean, over the
profiled steps that hold an ``np_plus`` span, of the forward and backward
device time of the work under ``np_plus`` (both sites, their draws
included)."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    if j is None:
        return None
    fired = j.steps_with("np_plus")
    if not fired:
        return None
    return 1e3 * j.device_s({"np_plus"}, steps=fired) / len(fired)
