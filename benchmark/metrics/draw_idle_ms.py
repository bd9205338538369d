"""Device idle time a profiled step while the main thread was drawing the
perturbation on the host: inside ``oc.redraw`` (the OC buffers' CPU draw
and copy) or ``np_plus.draw`` (NP+'s draws)."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    if j is None or not j.steps:
        return None
    return 1e3 * j.idle_s({"oc.redraw", "np_plus.draw"}) / len(j.steps)
