"""The flash backward's share of its roofline in training: the bound of
the work the attention's gradients need (``flops.flash_bwd_work``, at
the dense bf16 peak and the memory bandwidth, once a layer a step)
against the device time of the backward's kernels in the trace. None
where the trace holds no such kernel."""
from bench import flops
from bench.devtrace import share

UNIT, LAYER, MOVES = "%", "kernels", "train_tokens_per_s"


def read(run):
    pk = flops.peaks(run["kind"])
    spent = run["trace"]["device_s_by_class"]["flash_bwd"]
    if pk is None or spent <= 0:
        return None
    cfg, tr = run["config"], run["traffic"]
    f, nb = flops.flash_bwd_work(tr["batch"], tr["seq_len"],
                                 cfg["num_heads"], cfg["num_kv_heads"],
                                 cfg["head_dim"], True,
                                 cfg["compute_dtype"])
    calls = run["work"]["steps"] * cfg["num_layers"]
    bound = calls * flops.bound_s(f, nb, pk["bf16_flops_per_s"],
                                  pk["hbm_bytes_per_s"])
    return share(bound, spent)
