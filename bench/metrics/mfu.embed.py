"""The embedding pass's model FLOPs over the traced window, as a share
of the card's dense TF32 peak (the fastest rate it has for products of
float32 accuracy): ``flops.vit_flops_per_image`` for every patch the
window embedded."""
from bench import flops
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "model step", "patches_per_s"


def read(run):
    pk = flops.peaks(run["kind"])
    if pk is None:
        return None
    done = flops.vit_flops_per_image(run["config"]) * run["work"]["patches"]
    return share(done / run["trace"]["window_s"], pk["tf32_flops_per_s"])
