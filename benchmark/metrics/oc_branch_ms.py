"""What the OC branch adds to a step: the mean device time of the window's
steps whose stem OC gate fired, less that of the steps where neither OC
gate (stem or decoder) fired."""


def read(m):
    fired = [t for t, g in zip(m.step_ms, m.gates) if g[0]]
    neither = [t for t, g in zip(m.step_ms, m.gates) if not g[0] and not g[2]]
    if not fired or not neither:
        return None
    return sum(fired) / len(fired) - sum(neither) / len(neither)
