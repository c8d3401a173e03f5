"""The flash forward's share of its roofline in the embedding pass: the
bound of the attention the window's batches need (each layer's, with
``flops.flash_fwd_work`` at the dense TF32 peak and the memory
bandwidth) against the device time of the forward's kernels in the
trace. None where the trace holds no such kernel."""
from bench import flops
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "kernels", "patches_per_s"


def read(run):
    pk = flops.peaks(run["kind"])
    spent = run["trace"]["device_s_by_class"]["flash_fwd"]
    if pk is None or spent <= 0:
        return None
    cfg, tr = run["config"], run["traffic"]
    s = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    f, nb = flops.flash_fwd_work(tr["batch"], s, cfg["num_heads"],
                                 cfg["num_kv_heads"], cfg["head_dim"],
                                 False, cfg["compute_dtype"])
    calls = run["work"]["patches"] // tr["batch"] * cfg["num_layers"]
    bound = calls * flops.bound_s(f, nb, pk["tf32_flops_per_s"],
                                  pk["hbm_bytes_per_s"])
    return share(bound, spent)
