"""Host seconds of the ISW statistics pass's k-means: the ``isw.kmeans``
spans of the run, all of them in set-up."""

from benchmark import spans


def read(m):
    recorded = spans.program_spans() if m.device.type == "cuda" else None
    runs = [s for s in recorded or () if s.name == "isw.kmeans"]
    if not runs:
        return None
    return sum(s.end_ns - s.start_ns for s in runs) * 1e-9
