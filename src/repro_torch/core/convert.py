"""Carry state built elsewhere into the port.

``index_from_arrays`` wraps the fields of a zone-map index, given as numpy
arrays (for instance read off the reference engine's indexes), in the
port's ``ZoneMapIndex`` on a chosen device; ``SearchEngine.from_arrays``
assembles a whole engine from such state. ``catalog_from_arrays`` does
the same for a live catalog (its sealed segments, validity mask, live
feature range and epoch counters), and ``SearchEngine.from_catalog``
serves it. An engine built this way answers exactly as one that built
the same state itself.

``vit_from_numpy`` turns a reference ViT parameter tree (``init_vit`` of
``repro.features.vit``, or trained weights, with numpy leaves) into the
port's ``ViT``; ``dino_state_from_numpy`` does the same for a whole
reference ``DinoState`` (both ViTs, heads, centre, Adam's moments, step).

``lm_from_numpy`` turns a reference LM parameter tree (``init_params`` of
``repro.models.lm``, numpy leaves) into the port's ``LM``;
``caches_from_numpy`` / ``caches_to_numpy`` carry prefill / decode caches
between the reference's {"blocks", "tail"} tree and the port's per-layer
list, so a decode on either side can start from the other's caches.

``train_state_from_numpy`` / ``train_state_to_numpy`` carry a whole LM
``TrainState`` across, both ways: the reference's {params, opt: {m, v,
step}, step} with every layer leaf stacked over blocks, the port's model,
AdamW moments by parameter name and steps. A state placed on a mesh goes
out as the same full arrays (each leaf gathered whole: every rank of the
mesh takes part) and comes in as each rank's shard cut from them
(``load_train_state_``), so a state saved on one mesh loads onto another
or onto one device. bfloat16 leaves travel as
their bits in 2-byte void arrays (dtype ``V2``), which is what
``np.asarray`` of a JAX bfloat16 array holds once ``np.save`` wrote and
``np.load`` read it back (no ``ml_dtypes`` needed).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import DTensor
from repro_torch.configs.base import ModelConfig
from repro_torch.core.index import ZoneMapIndex
from repro_torch.core.segments import SegmentedCatalog
from repro_torch.device import resolve_device
from repro_torch.features.dino import DinoState
from repro_torch.features.vit import ViT, load_arrays
from repro_torch.launch import sharding
from repro_torch.models.common import gather_placed, local
from repro_torch.models.lm import LM, place_param
from repro_torch.models.rglru import LRUState
from repro_torch.models.ssm import SSMState

# bfloat16 bits as numpy holds them without ml_dtypes
BF16_BITS = np.dtype("V2")


def index_from_arrays(dims, perm, rows, zlo, zhi, block: int, n_rows: int,
                      subset_id: int = -1, device=None) -> ZoneMapIndex:
    """A ZoneMapIndex over the given fields; the device mirrors upload to
    ``device`` (default CUDA) at first use."""
    rows = np.ascontiguousarray(rows, np.float32)
    zlo = np.ascontiguousarray(zlo, np.float32)
    zhi = np.ascontiguousarray(zhi, np.float32)
    perm = np.asarray(perm)
    block = int(block)
    if rows.shape[0] % block or perm.shape[0] != rows.shape[0]:
        raise ValueError("rows and perm must cover whole blocks")
    if zlo.shape != (rows.shape[0] // block, rows.shape[1]) \
            or zhi.shape != zlo.shape:
        raise ValueError("zone maps must be [n_blocks, d']")
    return ZoneMapIndex(np.asarray(dims), perm, rows, zlo, zhi, block,
                        int(n_rows), int(subset_id),
                        device=resolve_device(device))


def catalog_from_arrays(x, subsets, segments, valid, frange, *, block: int,
                        epoch: int = 0, geom: int = 0, n_shards: int = 1,
                        next_shard: int = 0,
                        device=None) -> SegmentedCatalog:
    """A live SegmentedCatalog over the given state: ``x`` the [n, D]
    features of every physical row, ``subsets`` [K, d'], ``segments`` one
    dict a sealed segment — ``offset``, ``rows`` (its row count),
    ``shard`` and ``indexes``, one dict of ``perm``, ``rows``, ``zlo``,
    ``zhi`` a subset — ``valid`` the [n] bool validity mask, ``frange``
    the live rows' (lo [D], hi [D]), ``epoch`` / ``geom`` the mutation
    and compaction counters, ``next_shard`` the shard the next append
    lands on. The mirrors upload to ``device`` (default CUDA) at first
    use."""
    device = resolve_device(device)
    subsets = np.asarray(subsets)
    segs = []
    for sg in sorted(segments, key=lambda e: int(e["offset"])):
        m = int(sg["rows"])
        if len(sg["indexes"]) != len(subsets):
            raise ValueError("a segment needs one index a subset")
        ixs = [index_from_arrays(subsets[k], ix["perm"], ix["rows"],
                                 ix["zlo"], ix["zhi"], block, m, k,
                                 device=device)
               for k, ix in enumerate(sg["indexes"])]
        segs.append((int(sg["offset"]), m, int(sg["shard"]), ixs))
    ends = [o + m for o, m, _, _ in segs]
    if [o for o, _, _, _ in segs] != [0] + ends[:-1] \
            or ends[-1] != len(x) or len(valid) != len(x):
        raise ValueError("segments must cover the rows contiguously")
    return SegmentedCatalog._from_state(
        x, subsets, segs, valid, frange, block=block, epoch=epoch,
        geom=geom, n_shards=n_shards, next_shard=next_shard, device=device)


def vit_from_numpy(params, cfg: ModelConfig, *, image_size: int,
                   patch_size: int, device=None):
    """The port's ViT holding the reference tree ``params``: {patch_proj,
    patch_bias, cls, pos, final_norm, layers: {norm1, attn: {wq, wk, wv,
    wo}, norm2, mlp: {w_in, w_out}}}, numpy leaves, each layer leaf
    stacked [L, ...] as ``jax.vmap`` made it. Weights keep their [in, out]
    layout. ``device`` defaults to CUDA."""
    model = ViT(cfg, image_size=image_size, patch_size=patch_size,
                device=device)
    load_arrays(model, _vit_arrays(params, cfg))
    return model


def _vit_arrays(params, cfg: ModelConfig) -> dict:
    """A reference ViT tree as {the port's parameter name: array}."""
    arrays = {k: params[k] for k in ("patch_proj", "patch_bias", "cls",
                                     "pos", "final_norm")}
    lay = params["layers"]
    per_layer = {"norm1": lay["norm1"], "norm2": lay["norm2"],
                 **{k: lay["attn"][k] for k in ("wq", "wk", "wv", "wo")},
                 **{k: lay["mlp"][k] for k in ("w_in", "w_out")}}
    for name, stacked in per_layer.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers.{name}: {stacked.shape[0]} layers "
                             f"stacked, the config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            arrays[f"layers.{i}.{name}"] = stacked[i]
    return arrays


def dino_state_from_numpy(state, cfg: ModelConfig, *, image_size: int,
                          patch_size: int, device=None) -> DinoState:
    """The port's DinoState holding a reference ``DinoState`` with numpy
    leaves: student and teacher by ``vit_from_numpy``, the heads {w1, w2},
    the centre, ``opt_m`` / ``opt_v`` (pytrees (student, head_s)) under
    the names ``DinoState.trainables`` gives, and the step. ``device``
    defaults to CUDA."""
    dev = resolve_device(device)
    vit = dict(cfg=cfg, image_size=image_size, patch_size=patch_size,
               device=dev)
    student = vit_from_numpy(state.student, **vit).requires_grad_(True)
    teacher = vit_from_numpy(state.teacher, **vit)

    def tensor(a, grad=False):
        return torch.tensor(np.asarray(a, np.float32), device=dev,
                            requires_grad=grad)

    def heads(tree, grad=False):
        if set(tree) != {"w1", "w2"}:
            raise ValueError(f"a head holds w1 and w2, got {sorted(tree)}")
        return {k: tensor(tree[k], grad) for k in ("w1", "w2")}

    def moments(pair):
        vit_tree, head = pair
        return {**{f"student.{n}": tensor(a)
                   for n, a in _vit_arrays(vit_tree, cfg).items()},
                **{f"head_s.{n}": w for n, w in heads(head).items()}}

    out = DinoState(student, teacher, heads(state.head_s, True),
                    heads(state.head_t), tensor(state.center),
                    moments(state.opt_m), moments(state.opt_v),
                    int(np.asarray(state.step)))
    for name, p in out.trainables().items():
        for which in (out.opt_m, out.opt_v):
            if name not in which or which[name].shape != p.shape:
                raise ValueError(f"moment {name} is missing or has another "
                                 f"shape than its parameter")
    return out


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones too, as ``np.asarray`` of a JAX
    array gives them, or as their bits in ``BF16_BITS``) as a tensor of
    the same dtype on ``device``."""
    a = np.array(a)           # a writable copy (JAX's arrays are not)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        t = torch.from_numpy(a.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as float32 (numpy has no
    bfloat16 of its own)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a nested dict tree, None leaves skipped."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        elif val is not None:
            yield path, val


def _layer_slots(cfg: ModelConfig):
    """(layer index, where) for every layer: ("blocks", "slotN", block)
    or ("tail", "layerN", None) in the reference's tree."""
    pattern, nblocks, tail = cfg.scan_pattern()
    n = len(pattern)
    for i in range(nblocks * n):
        yield i, ("blocks", f"slot{i % n}", i // n)
    for ti in range(len(tail)):
        yield nblocks * n + ti, ("tail", f"layer{ti}", None)


def lm_stacks(names, cfg: ModelConfig) -> dict:
    """{the reference's stacked leaf ``blocks.slotN.<path>``: the port's
    parameter names that form it, in block order} for the port's
    parameter ``names``: the optimizer's per-leaf rules read these
    leaves (``train.optimizer``). Tail layers and the top-level tensors
    are leaves of their own."""
    where = {i: key for i, (part, key, block) in _layer_slots(cfg)
             if block is not None}
    stacks = {}
    for name in names:
        if name.startswith("layers."):
            _, i, path = name.split(".", 2)
            if int(i) in where:
                stacks.setdefault(f"blocks.{where[int(i)]}.{path}",
                                  []).append(name)
    return stacks


def lm_arrays(params, cfg: ModelConfig) -> dict:
    """A reference LM tree as {the port's parameter name: array}: the
    scanned ``blocks/slotN`` leaves [nblocks, ...] unstacked, block b of
    slot s becoming layer b * len(pattern) + s, then ``tail/layerN``."""
    arrays = {k: params[k] for k in ("embed", "final_norm", "unembed")
              if params.get(k) is not None}
    for i, (part, key, block) in _layer_slots(cfg):
        for path, leaf in _leaves(params[part][key]):
            leaf = np.asarray(leaf)
            arrays[f"layers.{i}.{path}"] = leaf if block is None \
                else leaf[block]
    return arrays


def lm_from_numpy(params, cfg: ModelConfig, *, device=None, mesh=None,
                  mode: str = "fsdp_tp") -> LM:
    """The port's LM holding the reference tree ``params`` ({embed,
    final_norm, unembed?, blocks: {slotN: stacked layer tree}, tail:
    {layerN: layer tree}}, numpy leaves). ``device`` defaults to CUDA.

    ``mesh`` (a DeviceMesh): each parameter becomes this rank's shard, a
    DTensor placed by ``launch.sharding.param_spec`` in ``mode``; only
    the shard is converted and copied to ``device``, so no rank holds
    the whole model."""
    if mesh is None:
        model = LM(cfg, device=device)
        load_arrays(model, lm_arrays(params, cfg))
        return model
    dev = resolve_device(device)
    arrays = lm_arrays(params, cfg)
    model = LM(cfg, device="meta")
    names = dict(model.named_parameters())
    if set(arrays) != set(names):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(names) - set(arrays))}, unknown "
                         f"{sorted(set(arrays) - set(names))}")
    specs = sharding.lm_param_specs(model, cfg, mesh, mode)
    for name, p in names.items():
        a = np.asarray(arrays[name])
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(p.shape)}")
        place_param(model, name, _F32View(a), specs[name], mesh,
                    device=dev, dtype=p.dtype)
    return model


class _F32View:
    """A numpy array whose slices come out float32, as ``load_arrays``
    converts: ``sharding.place`` cuts the shard before anything is."""

    def __init__(self, a: np.ndarray):
        self.a, self.shape = a, a.shape

    def __getitem__(self, sl) -> np.ndarray:
        return np.asarray(self.a[sl], np.float32)


def load_tree(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a reference parameter tree (nested dicts, numpy leaves) of one
    of the LM's modules (``init_mlp``, ``init_moe``, ``init_ssd``,
    ``init_rglru``, a layer) into ``module``, key path for parameter
    name; returns the module."""
    load_arrays(module, dict(_leaves(tree)))
    return module


def caches_from_numpy(caches, cfg: ModelConfig, *, device=None) -> list:
    """The reference's caches ({"blocks": {slotN: stacked}, "tail":
    {layerN: ...}}, numpy leaves; SSM and LRU states as (conv, ssd) /
    (conv, h) pairs) as the port's per-layer list on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    out = []
    for i, (part, key, block) in _layer_slots(cfg):
        c = caches[part][key]
        pick = (lambda a: _tensor(a, dev)) if block is None \
            else (lambda a, b=block: _tensor(np.asarray(a)[b], dev))
        if kinds[i] == "S":
            out.append(SSMState(pick(c[0]), pick(c[1])))
        elif kinds[i] == "R":
            out.append(LRUState(pick(c[0]), pick(c[1])))
        else:
            out.append({"k": pick(c["k"]), "v": pick(c["v"])})
    return out


def caches_to_numpy(caches: list, cfg: ModelConfig) -> dict:
    """The port's per-layer caches in the reference's tree ({"blocks":
    {slotN: leaves stacked over blocks}, "tail": {layerN: ...}}), numpy
    leaves (bfloat16 as float32), SSM / LRU states as the port's
    ``SSMState`` / ``LRUState`` (the reference's field names)."""
    out = {"blocks": {}, "tail": {}}
    stacks = {}
    for i, (part, key, block) in _layer_slots(cfg):
        c = caches[i]
        leaves = c._asdict() if isinstance(c, tuple) else c
        arrays = {name: _numpy(a) for name, a in leaves.items()}
        if block is None:
            out["tail"][key] = _rebuild(c, arrays)
        else:
            stacks.setdefault(key, (c, []))[1].append(arrays)
    for key, (c, per_block) in stacks.items():
        out["blocks"][key] = _rebuild(c, {
            name: np.stack([a[name] for a in per_block])
            for name in per_block[0]})
    return out


def _rebuild(like, arrays: dict):
    return type(like)(**arrays) if isinstance(like, tuple) else arrays


# ----------------------------------------------------------------------
# the LM's train state
# ----------------------------------------------------------------------

class AdamWArrays(NamedTuple):
    """The reference's ``AdamWState`` with numpy leaves."""
    m: dict
    v: dict
    step: np.ndarray


class TrainStateArrays(NamedTuple):
    """The reference's ``TrainState`` with numpy leaves: the field names
    and order are its, so checkpoint leaf names match
    (``params/blocks/slot0/attn/wq``, ``opt/m/...``, ``opt/step``,
    ``step``)."""
    params: dict
    opt: AdamWArrays
    step: np.ndarray


def _field(tree, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _leaf_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy copy; bfloat16 as its bits (``BF16_BITS``). A
    DTensor is gathered whole first (a collective: every rank of its mesh
    calls this in the same order)."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            t = gather_placed(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def nest(flat: dict, sep: str = ".") -> dict:
    """{"attn.wq": a, "norm1": b} -> {"attn": {"wq": a}, "norm1": b}
    (paths split at ``sep``)."""
    out = {}
    for path, leaf in flat.items():
        *head, last = path.split(sep)
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = leaf
    return out


def lm_tree(arrays: dict, cfg: ModelConfig) -> dict:
    """{the port's parameter name: array} (parameters, or AdamW's moments
    by parameter name) as the reference's LM tree: ``blocks/slotN``
    leaves stacked over blocks, ``tail/layerN``, ``unembed`` only where
    untied — the inverse of ``lm_arrays``."""
    tree = {"embed": arrays.get("embed"), "final_norm": arrays["final_norm"]}
    if "unembed" in arrays:
        tree["unembed"] = arrays["unembed"]
    per_layer = {}
    for name, a in arrays.items():
        if name.startswith("layers."):
            _, i, path = name.split(".", 2)
            per_layer.setdefault(int(i), {})[path] = a
    slots, tail = {}, {}
    for i, (part, key, block) in _layer_slots(cfg):
        if block is None:
            tail[key] = nest(per_layer[i])
        else:
            slots.setdefault(key, []).append(per_layer[i])
    tree["blocks"] = {key: nest({path: np.stack([b[path] for b in blocks])
                                 for path in blocks[0]})
                      for key, blocks in slots.items()}
    tree["tail"] = tail
    return tree


def train_state_to_numpy(state, cfg: ModelConfig) -> TrainStateArrays:
    """The port's ``launch.steps.TrainState`` as the reference's, numpy
    leaves (copies), bfloat16 as ``BF16_BITS``; the steps int32 0-d."""
    named = lambda tree: lm_tree({k: _leaf_numpy(t)
                                  for k, t in tree.items()}, cfg)
    params = dict(state.model.named_parameters())
    return TrainStateArrays(
        named(params),
        AdamWArrays(named(state.opt.m), named(state.opt.v),
                    np.asarray(state.opt.step, np.int32)),
        np.asarray(state.step, np.int32))


def _copy_named(targets: dict, arrays: dict, what: str) -> None:
    """Copy {name: array} into {name: tensor}: every name given, each of
    the target's exact shape and dtype (nothing is cast). A DTensor
    target takes this rank's shard of the array (``sharding.
    placed_slices``): only the shard is read and copied."""
    if set(arrays) != set(targets):
        raise ValueError(f"{what}: names differ: missing "
                         f"{sorted(set(targets) - set(arrays))}, unknown "
                         f"{sorted(set(arrays) - set(targets))}")
    with torch.no_grad():
        for name, t in targets.items():
            full = arrays[name]
            shape = tuple(np.shape(full))
            if isinstance(t, DTensor) and shape == tuple(t.shape):
                full = full[sharding.placed_slices(t)]
            a = _tensor(full, "cpu")
            if shape != tuple(t.shape) or a.dtype != t.dtype:
                raise ValueError(
                    f"{what} {name}: {a.dtype} {shape}, expected "
                    f"{t.dtype} {tuple(t.shape)} (no dtype is cast)")
            local(t).copy_(a)


def load_train_state_(target, state, cfg: ModelConfig):
    """Copy a reference ``TrainState`` (numpy leaves; or the same as
    nested dicts, as a checkpoint restores it) into the port's
    ``target`` TrainState in place; returns the TrainState with the
    loaded steps."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.train.optimizer import AdamWState
    opt = _field(state, "opt")
    _copy_named(dict(target.model.named_parameters()),
                lm_arrays(_field(state, "params"), cfg), "params")
    _copy_named(target.opt.m, lm_arrays(_field(opt, "m"), cfg), "opt.m")
    _copy_named(target.opt.v, lm_arrays(_field(opt, "v"), cfg), "opt.v")
    return TrainState(target.model,
                      AdamWState(target.opt.m, target.opt.v,
                                 int(np.asarray(_field(opt, "step")))),
                      int(np.asarray(_field(state, "step"))))


def train_state_from_numpy(state, cfg: ModelConfig, tc, *,
                           device=None, mesh=None):
    """The port's TrainState holding a reference ``TrainState`` with numpy
    leaves (``jax.tree_util.tree_map(np.asarray, state)``): parameters in
    ``cfg.param_dtype``, moments in ``tc.opt_state_dtype`` (the arrays
    must have those dtypes), the steps. ``device`` defaults to CUDA.
    ``mesh``: each rank holds its shards, placed by the rules in
    ``tc.sharding_mode`` (``launch.steps.init_train_state``'s
    placement)."""
    from repro_torch.launch.steps import (TrainState, check_mesh,
                                          make_optimizer, trainable_)
    check_mesh(mesh)
    dev = resolve_device(device)
    if mesh is None:
        model = LM(cfg, device=dev)
    else:
        model = LM(cfg, device="meta")
        specs = sharding.lm_param_specs(model, cfg, mesh, tc.sharding_mode)
        for name, p in list(model.named_parameters()):
            sh = sharding.NamedSharding(mesh, specs[name])
            shard = torch.empty(sh.shard_shape(tuple(p.shape)),
                                dtype=p.dtype, device=dev)
            prefix, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(prefix), leaf, torch.nn.Parameter(
                sharding.from_local(shard, sh, tuple(p.shape)),
                requires_grad=False))
        model.mesh = mesh
    trainable_(model)
    params = dict(model.named_parameters())
    opt = make_optimizer(tc, lm_stacks(params, cfg)).init(params)
    return load_train_state_(TrainState(model, opt, 0), state, cfg)
