"""Every image of every step in the window over the window's wall time,
which ends with a synchronize."""


def read(m):
    if m.traffic["driver"] != "train" or not m.window_s:
        return None
    return m.images / m.window_s
