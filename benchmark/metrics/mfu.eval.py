"""The eval forward's share of the card's fp32 peak outside the tensor
cores (the protocol runs with TF32 off): the reference's FLOPs an image
times the window's images, over the window's time."""

PEAK_FLOPS = 67e12  # H100 SXM, fp32 non-tensor


def read(m):
    if m.traffic["driver"] != "eval" or not m.window_s:
        return None
    flops = m.reference().eval_work(m.config, tuple(m.traffic["height_width"]))[0]
    return 100.0 * flops * m.images / m.window_s / PEAK_FLOPS
