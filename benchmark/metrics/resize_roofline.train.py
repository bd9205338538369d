"""The resize kernels' share of their roofline in the profiled steps: the
least time their bytes take at the card's HBM rate, over their summed
device time by kernel name.

The bytes are the reference's resizes for each profiled step's gates
(``train_work``), forward and, where the input takes a gradient, backward:
each input read once and each output written once, activations at the
recipe's compute dtype, label maps as the fp32 map the port resizes."""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
KERNELS = r"resize_(bilinear|nearest)"
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def step_bytes(calls, compute_dtype: str) -> int:
    total = 0
    for c in calls:
        size = 4 if c["labels"] else SIZE[compute_dtype]
        moved = c["n"] * c["c"] * (c["in_hw"][0] * c["in_hw"][1] + c["out_hw"][0] * c["out_hw"][1])
        total += moved * size * (2 if c["grad"] else 1)
    return total


def read(m):
    if m.profile is None or m.traffic["driver"] != "train":
        return None
    seconds = m.profile.device_seconds(KERNELS)
    if seconds <= 0:
        return None
    ref, cache, total = m.reference(), {}, 0
    for gates in m.profile_gates:
        if gates not in cache:
            cache[gates] = step_bytes(ref.train_work(m.config, gates)[1],
                                      m.config["train"]["compute_dtype"])
        total += cache[gates]
    return 100.0 * total / HBM_BYTES_PER_S / seconds
