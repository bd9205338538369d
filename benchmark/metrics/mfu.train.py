"""The train step's share of the card's bf16 dense peak: the FLOPs of every
window step, as the reference counts them for the gates that step drew
(forward and backward, convolutions and products), over the window's time."""

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense


def read(m):
    if m.traffic["driver"] != "train" or not m.window_s:
        return None
    ref, cache = m.reference(), {}
    total = 0
    for gates in m.gates:
        if gates not in cache:
            cache[gates] = ref.train_work(m.config, gates)[0]
        total += cache[gates]
    return 100.0 * total / m.window_s / PEAK_FLOPS
