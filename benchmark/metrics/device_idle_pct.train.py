"""The share of the profiled sub-window in which no kernel, copy or memset
ran on the card."""


def read(m):
    if m.profile is None or m.traffic["driver"] != "train":
        return None
    return 100.0 * (1.0 - m.profile.busy_s() / m.profile.window_s)
