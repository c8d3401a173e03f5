"""Multi-pod dry run — counterpart of ``repro.launch.dryrun``: one step of
every (arch x shape x mesh) cell, traced on the ``meta`` device over a
fake world of 256 or 512 ranks, allocating nothing on any device.

The reference lowers and compiles each cell for 512 placeholder CPU
devices and reads XLA's analyses. The port has nothing to compile: it
runs one rank's step eagerly on meta tensors and records it.
  * The world is a fake process group (``torch.testing._internal.
    distributed.fake_pg``): 256 ranks (16 x 16) or 512 (2 x 16 x 16) in
    this one process, every collective returning at once with its
    output's shape. It is started inside ``run_cell`` / ``fake_world``
    and destroyed after; importing this module starts nothing (the
    reference sets ``XLA_FLAGS`` at import, the port sets nothing).
  * The mesh is ``launch.mesh.make_production_mesh(device_type="cpu")``
    over the fake ranks; the state, the batch and the caches are meta
    tensors placed on it as the card's run places them (``init_train_
    state(..., device="meta", mesh=)``, ``lm.init_params(...)``,
    ``lm.init_caches(..., ctx=)``), and the kernels go by their meta
    routes (``kernels/meta.py``). A serving cell's parameters are placed
    by the fsdp_tp rules, the layout the port's prefill and decode take
    (the reference places them in the train config's mode, zero3 for the
    dense archs, and GSPMD reshards inside the step).
  * The step is the card's: a train cell runs the whole
    ``make_train_step`` (forward, backward, clip, AdamW), a prefill cell
    ``make_prefill_step``, a decode cell ``make_decode_step`` at ``pos =
    seq_len - 1`` (the port's decode takes a Python int; the reference's
    spec is an int32 scalar, counted as 4 argument bytes here too where
    a layer reads it: jit drops an argument nothing reads, as mamba2's
    decode does its ``pos``).
  * ``launch.hlo_analysis.OpTrace`` records it, ``analyze`` prices it;
    the collectives are the step's ``ctx.comm`` (``models.common.
    CommStats``), kept raw as ``comm``.

The figures are rank 0's. ``sharding.split`` gives rank 0 the ``ceil``
part of every uneven split, so rank 0 is the largest rank. A train
step's arguments are the rank's local shards of the parameters and the
moments, the whole batch (every rank of the port is given the whole
batch) and 8 bytes for the step key (the reference's uint32[2] key; the
port's generator is host state).

The JSON keys are the reference's, read so: ``lower_s`` is the seconds to
build the meta state, ``compile_s`` those of the traced step,
``xla_flops_per_device`` the products' FLOPs (what ``FlopCounterMode``
counts), ``xla_bytes_per_device`` the every-op byte bound,
``collectives_raw`` the collectives as counted (eager: every call is
counted, none once a loop), ``hlo_ops`` the ops in the trace, ``hlo_gz``
its file (``<cell>.trace.json.gz``, which ``reanalyze`` reads); ``comm``
is new.

Against the reference at one device (tests/test_torch_dryrun.py; the
reference cannot lower any mesh cell on the CPU, ROADMAP C6): the
arguments exactly, prefill and decode ``dot_flops`` exactly at the
reduced sizes, and the train step's within ``TRAIN_DOT_RTOL``. The train
gap, term by term (batch 4 x 64, remat "full", no loss chunks):
  * Both recompute each layer's forward in the backward but its last
    product (the MLP's down projection, or the SSD's out projection),
    whose output no backward needs: ``torch.utils.checkpoint`` stops its
    recompute early, XLA removes the dead product.
  * +2·B·S·d·V: the port's cross-entropy runs under its own checkpoint
    (``lm.chunked_ce_loss``), so the unembedding product is recomputed
    in the backward; the reference's is not. That is the whole gap for
    internlm2 (+16,777,216 = +2.44 %) and qwen3-moe (+0.64 %).
  * mamba2 (+2.01 %): the same +16,777,216, less 6,553,600 the
    reference's backward does and the port's does not. Autograd skips
    the gradient of a constant or of an unused value, where XLA's
    transpose of the reference's chunk loop differentiates every chunk
    alike: the first chunk's carried state is the zero initial state (its
    inter-chunk product's state gradient, 2 x 1,048,576), and the last
    chunk's state update feeds nothing in training (both gradients of
    its product, 4 x 1,048,576); and the reference's backward of the
    three-operand state-update einsum has two small dots (2 x 131,072)
    that the port's pairwise einsum backward does elementwise.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                # every live cell
  python -m repro_torch.launch.dryrun --all --multi-pod    # 2x16x16 mesh
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import gzip
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.compat import DTensor, local_tensor
from repro_torch.configs import (ASSIGNED_ARCHS, make_run_config,
                                 shape_cells)
from repro_torch.configs.base import (SHAPES_BY_NAME, ModelConfig,
                                      ServeConfig, ShapeConfig, TrainConfig)
from repro_torch.launch import specs
from repro_torch.launch.hlo_analysis import OpTrace, analyze
from repro_torch.launch.mesh import make_production_mesh, mesh_of
from repro_torch.launch.steps import (init_train_state, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import lm

ART_DIR = (Path(__file__).resolve().parents[3] / "experiments" / "artifacts"
           / "dryrun_torch")
RNG_BYTES = 8          # the reference's uint32[2] step key
POS_BYTES = 4          # the reference's int32 decode position
TRAIN_DOT_RTOL = 0.03  # the train step's dot FLOPs against the reference
TRACE_SUFFIX = ".trace.json.gz"


def _clear_dtensor_caches() -> None:
    """DTensor caches its sharding propagation by op schema, and a
    DeviceMesh equals another of the same ranks and names whatever its
    process groups: a spec cached in one world would carry that world's
    mesh, and its destroyed groups, into the next. Both the Python caches
    and the C++ dispatch fast path's (where torch has one) are emptied."""
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        fn = getattr(prop, name, None)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks in this process, this one
    ``rank`` (the "fake" backend: every collective returns at once), for
    the ``with`` block; refuses to start inside an initialised world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake world; this "
                           "process already has a process group")
    _clear_dtensor_caches()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _clear_dtensor_caches()


def _reads_pos(cfg: ModelConfig) -> bool:
    """Whether a decode step reads its position: an attention layer (its
    cache slot, RoPE) or sinusoidal position embeddings; SSM and RG-LRU
    layers carry their state without it."""
    return cfg.pos_embed == "sinusoidal" or any(
        k not in ("S", "R") for k in cfg.layer_kinds())


def _local(t) -> torch.Tensor:
    return local_tensor(t) if isinstance(t, DTensor) else t


def _nbytes(tensors) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tensors)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, *,
               tc: Optional[TrainConfig] = None,
               sv: Optional[ServeConfig] = None, mesh=None,
               what: str = "step") -> dict:
    """One step of ``shape``'s kind on meta tensors (on ``mesh``, a
    DeviceMesh of a running world, or one device), traced. ``what``:
    "step", or for a train cell "loss_and_grads" (the step's forward and
    backward alone). Returns {"trace", "memory", "lower_s", "compile_s",
    "state_bytes"} (``state_bytes``: the parameters', or a train step's
    parameters' and moments', on this rank)."""
    tc = tc or TrainConfig()
    sv = sv or ServeConfig()
    t0 = time.perf_counter()
    extra = 0
    if shape.kind == "train":
        state = init_train_state(cfg, tc, generator=torch.Generator()
                                 .manual_seed(0), device="meta", mesh=mesh)
        step = make_train_step(cfg, tc, mesh)
        batch = specs.train_batch_specs(cfg, shape)
        held = [*state.model.parameters(), *state.opt.m.values(),
                *state.opt.v.values()]
        args = (held, batch)
        extra = RNG_BYTES
        gen = torch.Generator().manual_seed(1)
        if what == "loss_and_grads":
            call = lambda: step.loss_and_grads(state, batch, gen)
        else:
            def call():
                new, metrics = step(state, batch, gen)
                return list(new.model.parameters()), new.opt, metrics
    else:
        model = (specs.params_specs(cfg) if mesh is None else
                 lm.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="meta", mesh=mesh))
        held = list(model.parameters())
        if shape.kind == "prefill":
            step = make_prefill_step(cfg, sv, mesh)
            inputs = specs.prefill_specs(cfg, shape)
            args = (held, inputs)
            call = lambda: step(model, *inputs)
        else:
            step = make_decode_step(cfg, sv, mesh)
            caches, token, _ = specs.decode_specs(cfg, shape, sv)
            if mesh is not None:
                caches = lm.init_caches(cfg, shape.global_batch,
                                        shape.seq_len, sv, device="meta",
                                        ctx=step.ctx)
            args = (held, caches, token)
            extra = POS_BYTES if _reads_pos(cfg) else 0
            call = lambda: step(model, caches, token, shape.seq_len - 1)
    lower_s = time.perf_counter() - t0
    step.ctx.comm.reset()
    with OpTrace(args) as tr:
        out = call()
    memory = tr.finish(out)
    memory["argument_bytes"] += extra
    memory["peak_bytes_est"] += extra
    return {"trace": tr.trace(step.ctx.comm.snapshot()), "memory": memory,
            "lower_s": lower_s,
            "compile_s": time.perf_counter() - t0 - lower_s,
            "state_bytes": _nbytes(held)}


def summarize(deep: dict) -> dict:
    """``analyze``'s keys under the reference's per-device names."""
    return dict(
        xla_flops_per_device=deep["dot_flops"],
        xla_bytes_per_device=deep["hbm_bytes_upper"],
        flops_per_device=deep["total_flops"],
        dot_flops_per_device=deep["dot_flops"],
        hbm_bytes_per_device=deep["hbm_bytes"],
        hbm_bytes_upper_per_device=deep["hbm_bytes_upper"],
        collective_bytes_per_device=deep["collective_bytes"],
        collectives=deep["collectives"],
        collectives_raw={**deep["collectives"],
                         "total_bytes": deep["collective_bytes"]},
        comm=deep["comm"],
        dot_flops_backward_per_device=deep["dot_flops_backward"],
        flash_causal_flops_per_device=deep["flash_causal_flops"],
        kernels=deep["kernels"],
        hlo_ops=deep["n_ops"],
    )


def dry_run(cfg: ModelConfig, shape: ShapeConfig, *,
            tc: Optional[TrainConfig] = None,
            sv: Optional[ServeConfig] = None, mesh_shape=None,
            rank: int = 0, what: str = "step") -> dict:
    """``trace_step`` in a fake world of prod(``mesh_shape``) ranks as
    ``rank`` on a (data, model) mesh of ``mesh_shape`` (one device where
    ``mesh_shape`` is None), summarised: ``memory``, ``state_bytes``,
    ``summarize``'s keys and the ``trace``."""
    def run(mesh):
        r = trace_step(cfg, shape, tc=tc, sv=sv, mesh=mesh, what=what)
        return {"memory": r["memory"], "state_bytes": r["state_bytes"],
                "lower_s": r["lower_s"], "compile_s": r["compile_s"],
                **summarize(analyze(r["trace"])), "trace": r["trace"]}
    if mesh_shape is None:
        return run(None)
    n = 1
    for s in mesh_shape:
        n *= s
    with fake_world(n, rank):
        return run(mesh_of(tuple(mesh_shape), ("data", "model"), "cpu"))


def _configs(arch: str, shape_name: str, multi_pod: bool, overrides):
    """(cfg, tc, sv) of a production cell, ``overrides`` applied as the
    reference applies them."""
    rc = make_run_config(arch, shape_name, multi_pod=multi_pod)
    overrides = overrides or {}
    tc_over = {k: v for k, v in overrides.items()
               if k in ("sharding_mode", "microbatches", "remat")}
    tc = dataclasses.replace(rc.train, **tc_over) if tc_over else rc.train
    sv = (ServeConfig(seq_parallel=bool(overrides["seq_parallel"]))
          if "seq_parallel" in overrides else rc.serve)
    return rc.model, tc, sv


def cell_name(arch: str, shape_name: str, multi_pod: bool,
              tag: str = "") -> str:
    return (f"{arch}_{shape_name}_"
            f"{'pod2_2x16x16' if multi_pod else 'pod1_16x16'}{tag}")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, keep_hlo: bool = False,
             overrides=None, tag: str = "",
             art_dir: Optional[Path] = None) -> dict:
    """One production cell, rank 0 of the fake world; the reference's
    result dict (a failing cell is a report, ``ok`` False). The trace is
    always written (``keep_hlo`` is the reference's flag, kept for its
    callers); the JSON too where ``save``."""
    art_dir = Path(art_dir or ART_DIR)
    name = cell_name(arch, shape_name, multi_pod, tag)
    mesh_name = name[len(f"{arch}_{shape_name}_"):]
    world = 512 if multi_pod else 256
    t0 = time.perf_counter()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "devices": world, "rank": 0, "ok": False,
              "overrides": dict(overrides or {})}
    try:
        cfg, tc, sv = _configs(arch, shape_name, multi_pod, overrides)
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            r = trace_step(cfg, SHAPES_BY_NAME[shape_name], tc=tc, sv=sv,
                           mesh=mesh)
        result.update(ok=True, lower_s=round(r["lower_s"], 1),
                      compile_s=round(r["compile_s"], 1),
                      memory=r["memory"], state_bytes=r["state_bytes"],
                      **summarize(analyze(r["trace"])))
        art_dir.mkdir(parents=True, exist_ok=True)
        path = art_dir / (name + TRACE_SUFFIX)
        with gzip.open(path, "wt") as f:
            json.dump(r["trace"], f, separators=(",", ":"))
        result["hlo_gz"] = path.name
    except Exception as e:  # noqa: BLE001 — a failing cell is a report
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    result["seconds"] = round(time.perf_counter() - t0, 1)
    if save:
        art_dir.mkdir(parents=True, exist_ok=True)
        (art_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see configs)")
    ap.add_argument("--shape", help="shape cell name")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all live cells")
    ap.add_argument("--keep-hlo", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix (hillclimb)")
    ap.add_argument("--sharding-mode", default=None,
                    choices=["fsdp_tp", "zero3"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--art-dir", default=None,
                    help=f"where the files go (default {ART_DIR})")
    args = ap.parse_args(argv)

    overrides = {}
    if args.sharding_mode:
        overrides["sharding_mode"] = args.sharding_mode
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.seq_parallel:
        overrides["seq_parallel"] = True

    if args.all:
        cells = [(arch, sc.name) for arch in ASSIGNED_ARCHS
                 for sc in shape_cells(arch)]
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    art_dir = Path(args.art_dir or ART_DIR)
    failures = 0
    for arch, shape_name in cells:
        name = cell_name(arch, shape_name, args.multi_pod, args.tag)
        out = art_dir / f"{name}.json"
        if args.skip_existing and out.exists():
            if json.loads(out.read_text()).get("ok"):
                print(f"[skip] {name}")
                continue
        r = run_cell(arch, shape_name, args.multi_pod,
                     keep_hlo=args.keep_hlo, overrides=overrides,
                     tag=args.tag, art_dir=art_dir)
        if r["ok"]:
            gb = r["memory"]["peak_bytes_est"] / 2**30
            cb = r["collective_bytes_per_device"] / 2**20
            print(f"[ok]   {arch:28s} {shape_name:12s} {r['mesh']}  "
                  f"peak={gb:6.2f} GiB/dev  flops/dev="
                  f"{r['flops_per_device']:.3e}  coll={cb:.1f} MiB  "
                  f"(init {r['lower_s']}s step {r['compile_s']}s, "
                  f"{r['seconds']}s)", flush=True)
        else:
            failures += 1
            print(f"[FAIL] {arch} {shape_name} {r['mesh']}: {r['error']} "
                  f"({r['seconds']}s)", flush=True)
        gc.collect()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
