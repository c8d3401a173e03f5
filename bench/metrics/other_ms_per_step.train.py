"""Device milliseconds a training step outside cuBLAS's products and the
flash kernels: the eager elementwise ops, the loss, clipping and AdamW,
copies and sets, summed over the traced steps."""

UNIT, LAYER, MOVES = "ms", "model step", "train_tokens_per_s"
OUTSIDE = ("other", "memcpy_h2d", "memcpy", "memset")


def read(run):
    by = run["trace"]["device_s_by_class"]
    steps = run["work"]["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(by[c] for c in OUTSIDE) / steps
