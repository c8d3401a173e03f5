"""Time the flash attention forward kernel at its paths' shapes, so that
two versions of the port can be set side by side on one card.

    python3 tools/flash_times.py [--src DIR] [--splits 1,2,3]
                                 [--only SHAPE,...] [--iters N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's): another commit, unpacked with ``git archive``
into a directory that .gitignore lists, is timed by the same script in
the same call. ``--splits`` also times the bf16 shapes with each of the
given key-split counts forced, where the wrapper has them
(``_fwd_splits``), and reports the largest difference of each output
from the wrapper's own choice. ``--only`` times the named shapes alone.
Prints the card's name and power limit, then one JSON line a shape:
event ms (the median of CUDA events around each call, so the host's
launch path where it is the longer), device ms (CUDA events around one
replay of a CUDA graph of the calls), the bytes one call allocates
beyond its output (its scratch: the peak of the caching allocator's
count less what it held before and the output) and, beside them, SDPA's
device ms (``torch.nn.functional.scaled_dot_product_attention`` on the
same inputs, timed only). Inputs are N(0, 1) from a seed; needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flash_bwd_times import event_ms, graph_ms  # noqa: E402

# name: (BH, S, G, D, causal, dtype), each path's forward call
SHAPES = {
    "vit_64x64": (384, 17, 1, 64, False, "float32"),
    "dino_400x400": (48, 626, 1, 64, False, "float32"),
    "extraction_400x400": (384, 626, 1, 64, False, "float32"),
    "lm_train": (16, 4096, 2, 128, True, "bfloat16"),
    "llama3_8b_prefill": (8, 4096, 4, 128, True, "bfloat16"),
    "mesh_head": (2, 4096, 2, 128, True, "bfloat16"),
    "mesh_data_model": (4, 4096, 2, 128, True, "bfloat16"),
    "mesh_train": (8, 4096, 2, 128, True, "bfloat16"),
    "mesh_moe": (1, 4096, 16, 128, True, "float32"),
}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--splits", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    forced = [int(n) for n in args.splits.split(",") if n]
    if forced and not hasattr(fa, "_fwd_splits"):
        raise SystemExit("--splits needs a wrapper that splits")
    only = [n for n in args.only.split(",") if n] or list(SHAPES)
    dev = torch.device("cuda", 0)
    for name in only:
        bh, s, g, d, causal, dt = SHAPES[name]
        gen = torch.Generator(device=dev).manual_seed(0)
        dtype = getattr(torch, dt)
        q = torch.randn(bh, s, g, d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(bh, s, d, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        call = lambda: fa.flash_attention(q, k, v, causal=causal)
        ql = q.permute(0, 2, 1, 3).contiguous()
        lib = lambda: F.scaled_dot_product_attention(
            ql, k[:, None], v[:, None], is_causal=causal, enable_gqa=g > 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        want = call()
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated(dev) - held
                   - want.numel() * want.element_size())
        row = {"shape": name, "bh": bh, "s": s, "g": g, "d": d,
               "causal": causal, "dtype": dt,
               "event_ms": event_ms(call, args.iters),
               "device_ms": graph_ms(call, args.iters),
               "scratch_bytes": scratch,
               "sdpa_device_ms": graph_ms(lib, args.iters)}
        if hasattr(fa, "_fwd_splits"):
            key = (dev.index, bh, s, g, fa.DTYPE_CODES[dtype])
            chosen = row["splits"] = fa._fwd_splits[key]
            for n in forced if dt == "bfloat16" else []:
                fa._fwd_splits[key] = n
                got = call()
                row[f"splits={n}"] = {
                    "device_ms": graph_ms(call, args.iters),
                    "max_abs_diff": float((got.float() - want.float())
                                          .abs().max())}
            fa._fwd_splits[key] = chosen
        print(json.dumps(row), flush=True)
        del q, k, v, ql, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
