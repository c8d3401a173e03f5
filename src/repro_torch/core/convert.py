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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.index import ZoneMapIndex
from repro_torch.core.segments import SegmentedCatalog
from repro_torch.device import resolve_device
from repro_torch.features.dino import DinoState
from repro_torch.features.vit import ViT, load_arrays
from repro_torch.models.lm import LM
from repro_torch.models.rglru import LRUState
from repro_torch.models.ssm import SSMState


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
    array gives them) as a tensor of the same dtype on ``device``."""
    a = np.array(a)           # a writable copy (JAX's arrays are not)
    if a.dtype.name == "bfloat16":
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


def lm_from_numpy(params, cfg: ModelConfig, *, device=None) -> LM:
    """The port's LM holding the reference tree ``params`` ({embed,
    final_norm, unembed?, blocks: {slotN: stacked layer tree}, tail:
    {layerN: layer tree}}, numpy leaves). ``device`` defaults to CUDA."""
    model = LM(cfg, device=device)
    load_arrays(model, lm_arrays(params, cfg))
    return model


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
