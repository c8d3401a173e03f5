"""The training steps' model FLOPs (PaLM's count, ``flops.lm_train_flops``)
over the traced window, as a share of the card's dense bf16 peak."""
from bench import flops
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "model step", "train_tokens_per_s"


def read(run):
    pk = flops.peaks(run["kind"])
    if pk is None:
        return None
    tr = run["traffic"]
    done = flops.lm_train_flops(run["config"], tr["batch"], tr["seq_len"]) \
        * run["work"]["steps"]
    return share(done / run["trace"]["window_s"], pk["bf16_flops_per_s"])
