"""Device time a profiled step of the work launched inside the program's
``train.forward`` spans (the model and the loss of each microbatch), read
from the trace joined to the spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(m):
    j = spans.joined(m)
    if j is None or not j.steps:
        return None
    return 1e3 * j.device_s({"train.forward"}, backward=False) / len(j.steps)
