"""Time the flash attention backward kernel at its paths' shapes, so that
two versions of the port can be set side by side on one card.

    python3 tools/flash_bwd_times.py [--src DIR] [--splits 1,2] [--iters N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's): another commit, unpacked with ``git archive``
into a directory that .gitignore lists, is timed by the same script in
the same call. Its wrapper may take (q, k, v, dout) or (q, k, v, out,
lse, dout). ``--splits`` also times the dk / dv kernel with each of the
given split counts forced (where the wrapper keeps its choice per shape),
and reports the largest difference of each one's gradients from the
wrapper's own choice. Prints one JSON line a shape: event ms (the median
of CUDA events around each call, so the host's launch path where it is
the longer), loop ms (the host's clock around calls back to back, the
least of five) and device ms (CUDA events around one replay of a CUDA
graph of the calls). Inputs are N(0, 1) from a seed; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

# name: (BH, S, G, D, causal, dtype), each path's backward call
SHAPES = {
    "dino_64x64": (192, 17, 1, 64, False, "float32"),
    "dino_400x400": (48, 626, 1, 64, False, "float32"),
    "lm_train": (16, 4096, 2, 128, True, "bfloat16"),
    "mesh_train": (8, 4096, 2, 128, True, "bfloat16"),
    "mesh_moe": (1, 4096, 16, 128, True, "float32"),
}


def event_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def loop_ms(fn, iters: int, repeats: int = 5) -> float:
    """The least, over ``repeats``, of the host's clock around ``iters``
    calls back to back and a synchronize, over ``iters``: the rate at
    which calls are issued and run, the host's launch path where it is
    the longer, with less of the shared host's noise than a median of
    single calls."""
    import torch
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def graph_ms(fn, iters: int) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--splits", default="")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    with_residuals = "lse" in inspect.signature(
        fa.flash_attention_bwd).parameters
    forced = [int(n) for n in args.splits.split(",") if n]
    if forced and not with_residuals:
        raise SystemExit("--splits needs a wrapper that takes out and lse")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (bh, s, g, d, causal, dt) in SHAPES.items():
        dtype = getattr(torch, dt)
        q, dout = (torch.randn(bh, s, g, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, s, d, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        if with_residuals:
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
            call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  causal=causal)
        else:
            call = lambda: fa.flash_attention_bwd(q, k, v, dout,
                                                  causal=causal)
        row = {"shape": name, "bh": bh, "s": s, "g": g, "d": d,
               "causal": causal, "dtype": dt,
               "event_ms": event_ms(call, args.iters),
               "loop_ms": loop_ms(call, 3 * args.iters),
               "device_ms": graph_ms(call, args.iters)}
        if forced:
            key = (dev.index, bh, s, g, fa.DTYPE_CODES[dtype])
            chosen = fa._splits[key]
            want = call()
            row["splits"] = chosen
            row["forced"] = {}
            for n in forced:
                fa._splits[key] = n
                got = call()
                row["forced"][n] = {
                    "event_ms": event_ms(call, args.iters),
                    "device_ms": graph_ms(call, args.iters),
                    "max_abs_diff": max(float((a.float() - b.float())
                                              .abs().max())
                                        for a, b in zip(got, want))}
            fa._splits[key] = chosen
        print(json.dumps(row), flush=True)
        del q, k, v, dout
        if with_residuals:
            del out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
