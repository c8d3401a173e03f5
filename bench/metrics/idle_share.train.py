"""Share of the traced window in which nothing ran on the card: no
kernel, copy or set (the device trace's busy time against the window)."""
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "device", "train_tokens_per_s"


def read(run):
    t = run["trace"]
    return share(t["window_s"] - t["busy_s"], t["window_s"])
