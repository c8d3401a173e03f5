"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/reanalyze.py``, the kernels' meta routes) against the
reference's and against a real world of ranks.

* One device, against the reference (run in one subprocess, ``XLA_FLAGS``
  set before JAX is imported; it cannot lower a mesh cell here, ROADMAP
  C6): reduced internlm2 (dense), qwen3-moe (MoE) and mamba2 (SSD), each
  as a train step (batch 4 x 64, remat "full", AdamW), a prefill (2 x 64)
  and a decode step (2, context 64). The arguments' bytes equal
  ``memory_analysis().argument_size_in_bytes`` exactly; prefill and
  decode ``dot_flops`` are within 0.5 % of ``hlo_analysis.analyze``'s
  (PREFILL_DECODE_RTOL; they are equal); the train step's within
  ``dryrun.TRAIN_DOT_RTOL`` (3 %), and for internlm2 and qwen3-moe
  exactly the reference's plus the port's recomputed unembedding product
  (2·B·S·d·V), the gap ``dryrun``'s docstring explains term by term.
* A mesh, against a world of 4 gloo ranks on the CPU (spawned once):
  fsdp_tp head (1, 4), data x model (2, 2) and zero3 (2, 2) over reduced
  internlm2 and qwen3-moe, one whole train step at 4 x 16. The fake
  world's dry run of rank 0 counts the collectives every rank counted,
  calls and bytes by kind, forward and backward, exactly, and its
  arguments are a rank's local shards of the parameters and moments,
  the batch and the step key.
* Each kernel's meta route gives its plain version's shape and dtype;
  ``analyze`` on a hand-built trace (products, elementwise ops, the
  fusion model's bytes, a flash call, the link-byte convention) and
  ``OpTrace``'s memory account on a known program are exact; a
  ``reanalyze`` round trip and the CLI under ``tmp_path``.
"""
from __future__ import annotations

import gzip
import json
import os
import queue
import subprocess
import sys
import textwrap
import traceback

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, hlo_analysis, reanalyze

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-1.3b")
# (kind, batch, seq_len) of the one-device cells
CELLS = (("train", 4, 64), ("prefill", 2, 64), ("decode", 2, 64))
PREFILL_DECODE_RTOL = 5e-3
# name -> (sharding mode, mesh shape) of the gloo world's layouts
LAYOUTS = {"head": ("fsdp_tp", (1, 4)), "data_model": ("fsdp_tp", (2, 2)),
           "zero3": ("zero3", (2, 2))}
MESH_ARCHS = ("internlm2-1.8b", "qwen3-moe-235b-a22b")
MESH_SHAPE = ShapeConfig("mesh", "train", 16, 4)
WORLD = 4
JOIN_S = 300


def train_config(mode: str = "fsdp_tp") -> TrainConfig:
    return TrainConfig(sharding_mode=mode, microbatches=1, remat="full")


def shape_of(kind: str, b: int, s: int) -> ShapeConfig:
    return ShapeConfig(f"{kind}_{b}x{s}", kind, s, b)


# ----------------------------------------------------------------------
# the reference, one subprocess
# ----------------------------------------------------------------------

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import json
import jax
import jax.numpy as jnp
from repro import configs
from repro.configs.base import ServeConfig, ShapeConfig, TrainConfig
from repro.launch import specs, steps
from repro.launch.hlo_analysis import analyze
out = {}
for arch in ARCHS:
    cfg = configs.get_reduced_config(arch)
    for kind, b, s in CELLS:
        shape = ShapeConfig("x", kind, s, b)
        if kind == "train":
            tc = TrainConfig(remat="full", microbatches=1)
            st = jax.eval_shape(lambda k: steps.init_train_state(k, cfg, tc),
                                jax.random.PRNGKey(0))
            fn = jax.jit(steps.make_train_step(cfg, tc, None),
                         donate_argnums=(0,))
            args = (st, specs.train_batch_specs(cfg, shape),
                    jax.ShapeDtypeStruct((2,), jnp.uint32))
        elif kind == "prefill":
            fn = jax.jit(steps.make_prefill_step(cfg, ServeConfig(), None))
            args = (specs.params_specs(cfg),) + tuple(
                specs.prefill_specs(cfg, shape))
        else:
            fn = jax.jit(steps.make_decode_step(cfg, ServeConfig(), None),
                         donate_argnums=(1,))
            args = (specs.params_specs(cfg),) + tuple(
                specs.decode_specs(cfg, shape, ServeConfig()))
        c = fn.lower(*args).compile()
        out[f"{arch}/{kind}"] = {
            "argument_bytes": c.memory_analysis().argument_size_in_bytes,
            "dot_flops": analyze(c.as_text())["dot_flops"]}
print("RESULT:" + json.dumps(out))
"""


def _start_reference() -> subprocess.Popen:
    prog = (f"ARCHS = {ARCHS!r}\nCELLS = {CELLS!r}\n"
            + textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _reference_result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stderr:\n{err[-4000:]}"
    for line in out.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line:\n{out[-2000:]}")


# ----------------------------------------------------------------------
# the gloo world
# ----------------------------------------------------------------------

def _local_bytes(tensors) -> int:
    from repro_torch.models.common import local
    return sum(local(t).numel() * local(t).element_size() for t in tensors)


def _rank_main(rank, world, init_file, q):
    """One rank: a whole train step of every (layout, arch); puts (rank,
    {(layout, arch): (comm, argument bytes)}) or a traceback on ``q``."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps as tsteps
    torch.set_num_threads(1)
    try:
        tmesh.init_process_group("gloo", rank=rank, world_size=world,
                                 init_method=f"file://{init_file}")
        res = {}
        for name, (mode, shape) in LAYOUTS.items():
            mesh = tmesh.mesh_of(shape, ("data", "model"), "cpu")
            for arch in MESH_ARCHS:
                cfg = tconfigs.get_reduced_config(arch)
                tc = train_config(mode)
                state = tsteps.init_train_state(
                    cfg, tc, generator=torch.Generator().manual_seed(0),
                    device="cpu", mesh=mesh)
                rng = np.random.default_rng(0)
                b, s = MESH_SHAPE.global_batch, MESH_SHAPE.seq_len
                batch = {k: torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (b, s)).astype(np.int32))
                    for k in ("inputs", "targets")}
                held = [*state.model.parameters(), *state.opt.m.values(),
                        *state.opt.v.values(), *batch.values()]
                step = tsteps.make_train_step(cfg, tc, mesh)
                step.ctx.comm.reset()
                step(state, batch, torch.Generator().manual_seed(1))
                res[(name, arch)] = (step.ctx.comm.snapshot(),
                                     _local_bytes(held) + dryrun.RNG_BYTES)
        q.put((rank, res))
    except Exception:
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_world(tmp_path) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, str(tmp_path / "store"), q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=JOIN_S)
            results[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    bad = [v for v in results.values() if isinstance(v, str)]
    assert not bad, "\n".join(bad)
    assert len(results) == WORLD, f"ranks answered: {sorted(results)}"
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's numbers and the gloo world's, made side by side
    (the subprocess compiles while the ranks train)."""
    proc = _start_reference()
    try:
        world = _run_world(tmp_path_factory.mktemp("dryrun_world"))
        ref = _reference_result(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"reference": ref, "world": world}


@pytest.fixture(scope="module")
def port():
    """The port's one-device dry run of every (arch, cell)."""
    out = {}
    for arch in ARCHS:
        cfg = tconfigs.get_reduced_config(arch)
        for kind, b, s in CELLS:
            out[f"{arch}/{kind}"] = dryrun.dry_run(
                cfg, shape_of(kind, b, s), tc=train_config())
    return out


CELL_IDS = [f"{a}/{k}" for a in ARCHS for k, _, _ in CELLS]


@pytest.mark.parametrize("cell", CELL_IDS)
def test_arguments_equal_the_reference(cell, runs, port):
    assert port[cell]["memory"]["argument_bytes"] \
        == runs["reference"][cell]["argument_bytes"]


@pytest.mark.parametrize("cell", CELL_IDS)
def test_dot_flops_match_the_reference(cell, runs, port):
    got = port[cell]["dot_flops_per_device"]
    want = runs["reference"][cell]["dot_flops"]
    tol = (dryrun.TRAIN_DOT_RTOL if cell.endswith("/train")
           else PREFILL_DECODE_RTOL)
    assert abs(got / want - 1) <= tol, (got, want)


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "qwen3-moe-235b-a22b"))
def test_train_gap_is_the_recomputed_unembedding(arch, runs, port):
    """The port's train step does the reference's products and the
    unembedding once more (the loss's checkpoint recomputes it)."""
    cfg = tconfigs.get_reduced_config(arch)
    b, s = CELLS[0][1:]
    unembed = 2 * b * s * cfg.d_model * cfg.padded_vocab
    assert port[f"{arch}/train"]["dot_flops_per_device"] - unembed \
        == runs["reference"][f"{arch}/train"]["dot_flops"]


@pytest.mark.parametrize("layout,arch", [(lay, a) for lay in LAYOUTS
                                         for a in MESH_ARCHS])
def test_mesh_comm_equals_the_gloo_world(layout, arch, runs):
    mode, shape = LAYOUTS[layout]
    cfg = tconfigs.get_reduced_config(arch)
    dry = dryrun.dry_run(cfg, MESH_SHAPE, tc=train_config(mode),
                         mesh_shape=shape)
    assert dry["comm"]["total_bytes"] > 0
    for rank, res in runs["world"].items():
        comm, arg_bytes = res[(layout, arch)]
        assert dry["comm"] == comm, rank
        assert dry["memory"]["argument_bytes"] == arg_bytes, rank


# ----------------------------------------------------------------------
# the meta routes
# ----------------------------------------------------------------------

def _kernel_inputs(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g)
    zlo = r(40, 6)
    blo = r(5, 6) * 0.5
    rows3 = r(40, 8, 6)
    cand = torch.tensor([3, 7, 0, 0], dtype=torch.int32)
    onehot = (torch.arange(5)[:, None] % 3 == torch.arange(3)[None]).float()
    q, k = r(2, 24, 2, 16), r(2, 24, 16)
    return {"zone_prune": ("zone_prune", (zlo, zlo + 0.2, blo, blo + 0.5)),
            "zone_hits": ("zone_hits", (zlo, zlo + 0.2, blo, blo + 0.5)),
            "zone_candidates": ("zone_candidates",
                                (zlo, zlo + 0.2, blo, blo + 0.5, 6)),
            "box_scan": ("box_scan", (r(50, 6), blo, blo + 0.5)),
            "box_scan_pruned": ("box_scan_pruned",
                                (rows3, cand, torch.tensor(2), blo,
                                 blo + 0.5)),
            "box_scan_seg": ("box_scan_seg",
                             (r(50, 6), blo, blo + 0.5, onehot)),
            "box_scan_seg_gather": ("box_scan_seg_gather",
                                    (rows3, cand, torch.tensor(2), blo,
                                     blo + 0.5, onehot)),
            "l2dist": ("l2dist", (r(50, 6), r(7, 6))),
            "flash_attention": ("_flash_forward", (q, k, k, True))}


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _specs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.device.type) for t in outs]


@pytest.mark.parametrize("kernel", sorted(_kernel_inputs()))
def test_meta_route_gives_the_plain_shape_and_dtype(kernel):
    entry, args = _kernel_inputs()[kernel]
    plain = getattr(kops, entry)(*args)              # CPU: kernels/ref.py
    meta = getattr(kops, entry)(*[_meta(a) for a in args])
    assert [s[:2] for s in _specs(meta)] == [s[:2] for s in _specs(plain)]
    assert {s[2] for s in _specs(meta)} == {"meta"}
    assert {s[2] for s in _specs(plain)} == {"cpu"}


def test_meta_flash_refuses_what_the_kernel_refuses():
    q = torch.empty((1, 8, 1, 24), device="meta")
    k = torch.empty((1, 8, 24), device="meta")
    with pytest.raises(ValueError, match="head dim"):
        kops._flash_forward(q, k, k, True)


def test_flash_attention_trains_on_meta():
    """The autograd Function's forward and backward take the meta routes:
    one forward and one backward kernel call in the trace, the backward
    priced as the reference's: it recomputes the scores and takes four
    products."""
    q = torch.empty((1, 32, 4, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 32, 2, 16), device="meta", requires_grad=True)
    with hlo_analysis.OpTrace() as tr:
        out = kops.flash_attention(q, k, k)
        torch.autograd.grad(out.sum(), (q, k))
    deep = hlo_analysis.analyze(tr.trace())
    assert deep["kernels"]["flash_attention"]["calls"] == 1
    assert deep["kernels"]["flash_attention_bwd"]["calls"] == 1
    fwd = 4 * 2 * 2 * 16 * 32 * 32        # BH 2, G 2, D 16, S 32
    assert deep["dot_flops"] - deep["dot_flops_backward"] == fwd
    assert deep["dot_flops_backward"] == fwd // 2 * 5
    causal = 4 * 2 * 2 * 16 * (32 * 33 // 2)
    assert deep["flash_causal_flops"] == causal + causal // 2 * 5


# ----------------------------------------------------------------------
# analyze and the memory account
# ----------------------------------------------------------------------

def test_analyze_hand_built_trace():
    f32 = lambda *s: ["float32", list(s)]
    bf = lambda *s: ["bfloat16", list(s)]
    trace = {"ops": [
        ["aten.mm.default", [f32(8, 16), f32(16, 4)], [f32(8, 4)], False,
         None],
        ["aten.addmm.default", [f32(4), f32(8, 16), f32(16, 4)],
         [f32(8, 4)], True, None],
        ["aten.bmm.default", [bf(3, 8, 16), bf(3, 16, 2)], [bf(3, 8, 2)],
         False, None],
        ["aten.add.Tensor", [f32(8, 4), f32(8, 4)], [f32(8, 4)], False,
         None],
        ["aten.view.default", [f32(8, 4)], [f32(32)], False, None],
        ["aten.sum.dim_IntList", [f32(8, 4)], [f32(8)], False, None],
        ["repro_torch.flash_attention.default",
         [bf(2, 64, 2, 32), bf(2, 64, 32), bf(2, 64, 32)],
         [bf(2, 64, 2, 32)], False, {"args": [True]}],
        ["repro_torch.box_scan.default", [f32(100, 6), f32(4, 6),
                                          f32(4, 6)],
         [["int32", [100]]], False, {"args": []}],
    ], "comm": {"calls": {"all_gather": 2, "all_reduce": 1},
                "bytes": {"all_gather": 1000, "all_reduce": 40},
                "total_bytes": 1040,
                "backward": {"calls": {"reduce_scatter": 2,
                                       "all_reduce": 1},
                             "bytes": {"reduce_scatter": 800,
                                       "all_reduce": 40},
                             "total_bytes": 840}}}
    d = hlo_analysis.analyze(trace)
    flash = 4 * 2 * 2 * 32 * 64 * 64
    products = 2 * 8 * 4 * 16 * 2 + 2 * 3 * 8 * 2 * 16
    assert d["dot_flops"] == products + flash
    assert d["dot_flops_backward"] == 2 * 8 * 4 * 16
    assert d["flash_causal_flops"] == 4 * 2 * 2 * 32 * (64 * 65 // 2)
    assert d["elementwise_flops"] == 8 * 4 + 3 * 100 * 4 * 6
    assert d["total_flops"] == d["dot_flops"] + d["elementwise_flops"]
    mm = 4 * (8 * 16 + 16 * 4 + 8 * 4)
    addmm = 4 * (4 + 8 * 16 + 16 * 4 + 8 * 4)
    bmm = 2 * (3 * 8 * 16 + 3 * 16 * 2 + 3 * 8 * 2)
    add, red = 4 * 3 * 32, 4 * (32 + 8)
    kern = 2 * (2 * (2 * 64 * 2 * 32) + 2 * (2 * 64 * 32)) \
        + 4 * (100 * 6 + 2 * 4 * 6 + 100)
    assert d["hbm_bytes"] == mm + addmm + bmm + red + kern
    assert d["hbm_bytes_upper"] == mm + addmm + bmm + add + red + kern
    assert d["collectives"] == {
        "all-gather": {"count": 2, "bytes": 1000},
        "all-reduce": {"count": 2, "bytes": 2 * 80},
        "reduce-scatter": {"count": 2, "bytes": 800}}
    assert d["collective_bytes"] == 1960
    assert d["kernels"]["box_scan"] == {"calls": 1, "flops": 3 * 100 * 4 * 6,
                                        "bytes": 4 * (100 * 6 + 48 + 100)}
    assert d["n_ops"] == 8 and d["n_backward_ops"] == 1


def test_optrace_memory_account():
    """Arguments a (4 KiB), b (2 KiB); the program makes x (4 KiB), frees
    it after y (4 KiB) is made from it, and returns y and a updated in
    place."""
    a = torch.zeros(1024)
    b = torch.zeros(512)
    with hlo_analysis.OpTrace((a, b)) as tr:
        x = a * 2
        y = x + 1
        del x
        z = b * 2                       # 2 KiB, freed before the end
        del z
        a.add_(1)
    m = tr.finish((y, a))
    assert m == {"argument_bytes": 6144, "output_bytes": 8192,
                 "temp_bytes": 4096, "alias_bytes": 4096, "code_bytes": 0,
                 "peak_bytes_est": 6144 + 8192}


# ----------------------------------------------------------------------
# reanalyze and the CLI
# ----------------------------------------------------------------------

def test_reanalyze_round_trip(tmp_path):
    cfg = tconfigs.get_reduced_config("internlm2-1.8b")
    r = dryrun.dry_run(cfg, shape_of("train", 2, 16), tc=train_config())
    trace = r.pop("trace")
    good = {"ok": True, "memory": r["memory"],
            **dryrun.summarize(hlo_analysis.analyze(trace))}
    stale = {**good, "dot_flops_per_device": 0.0, "flops_per_device": 0.0,
             "collectives": {"x": 1}}
    (tmp_path / "cell.json").write_text(json.dumps(stale))
    with gzip.open(tmp_path / ("cell" + dryrun.TRACE_SUFFIX), "wt") as f:
        json.dump(trace, f)
    (tmp_path / "notrace.json").write_text(json.dumps({"ok": True}))
    (tmp_path / "failed.json").write_text(json.dumps({"ok": False}))
    assert reanalyze.reanalyze(tmp_path) == (1, 2)
    got = json.loads((tmp_path / "cell.json").read_text())
    assert got == json.loads(json.dumps(good))
    assert got["dot_flops_per_device"] == r["dot_flops_per_device"] > 0


REFERENCE_KEYS = ("arch", "shape", "mesh", "devices", "ok", "overrides",
                  "lower_s", "compile_s", "memory", "xla_flops_per_device",
                  "xla_bytes_per_device", "flops_per_device",
                  "dot_flops_per_device", "hbm_bytes_per_device",
                  "hbm_bytes_upper_per_device",
                  "collective_bytes_per_device", "collectives",
                  "collectives_raw", "hlo_ops", "hlo_gz")


def test_cli_writes_a_production_cell(tmp_path, capsys):
    """internlm2-1.8b decode_32k on the 16 x 16 fake world."""
    assert dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                        "--art-dir", str(tmp_path)]) == 0
    assert "[ok]" in capsys.readouterr().out
    d = json.loads((tmp_path / "internlm2-1.8b_decode_32k_pod1_16x16.json")
                   .read_text())
    assert set(REFERENCE_KEYS) | {"comm"} <= set(d)
    assert d["devices"] == 256 and d["rank"] == 0
    assert (tmp_path / d["hlo_gz"]).exists()
    assert d["collectives"]["all-reduce"]["count"] > 0
    assert not torch.distributed.is_initialized()
