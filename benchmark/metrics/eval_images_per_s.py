"""Images whose sweep completed in the window over the window's wall time."""


def read(m):
    if m.traffic["driver"] != "eval" or not m.window_s:
        return None
    return m.images / m.window_s
