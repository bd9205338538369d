"""The OC branch's device time in a step whose stem OC gate fired: the mean,
over the profiled steps that re-drew the OC buffers (an ``oc.redraw``
span), of the forward and backward device time of the work under
``oc.redraw``, ``oc.encode`` and ``oc.decode``."""

from benchmark import spans

OC = {"oc.redraw", "oc.encode", "oc.decode"}


def read(m):
    j = spans.joined(m)
    if j is None:
        return None
    fired = j.steps_with("oc.redraw")
    if not fired:
        return None
    return 1e3 * j.device_s(OC, steps=fired) / len(fired)
