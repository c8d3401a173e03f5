"""Every public name of the reference package has a counterpart in the
port.

One case per module of ``src/repro/``: both trees are read by ``ast``
(neither package is imported). Every public top-level function, class
and assigned name, every public method of a public class, and every
name in an ``__all__`` must be defined, imported or listed in the port's
module of the same path. A name the port renamed must exist under its
mapped name (RENAMED); a name the port has no use for is listed with
its reason (NOT_PORTED). Both lists are held to the trees too: each
entry names a reference name that exists, and a NOT_PORTED name is
really missing.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

_DEV_TRAINER = ("the batched device trainer runs eager torch ops, not a "
                "jax.jit program: named for the device, not for JAX")
_KERNEL = ("the Pallas kernel's counterpart is the CUDA kernel's wrapper, "
           "named for the function it computes")
# (module, reference name) -> (port module, port name, reason)
RENAMED = {
    ("core/dbranch.py", "fit_dbranch_jax"):
        ("core/dbranch.py", "fit_dbranch_dev", _DEV_TRAINER),
    ("core/dbranch.py", "fit_select_jax"):
        ("core/dbranch.py", "fit_select", _DEV_TRAINER),
    ("core/dbranch.py", "predict_boxes_jax"):
        ("core/dbranch.py", "predict_boxes", _DEV_TRAINER),
    ("core/__init__.py", "__all__:fit_dbranch_jax"):
        ("core/__init__.py", "__all__:fit_dbranch_dev", _DEV_TRAINER),
    ("core/__init__.py", "__all__:fit_select_jax"):
        ("core/__init__.py", "__all__:fit_select", _DEV_TRAINER),
    ("core/__init__.py", "__all__:predict_boxes_jax"):
        ("core/__init__.py", "__all__:predict_boxes", _DEV_TRAINER),
    ("launch/search_dryrun.py", "search_step_specs"):
        ("launch/search_dryrun.py", "local_specs",
         "the port runs the steps for real on one card's shard, so its "
         "specs are the local ones"),
    ("launch/search_dryrun.py", "make_index_query_step"):
        ("core/index.py", "pruned_local_step",
         "the port's step is the index's own per-shard function; "
         "shard_map's wrapping has no counterpart"),
    ("kernels/zone_prune.py", "zone_prune_pallas"):
        ("kernels/zone_prune.py", "zone_prune", _KERNEL),
    ("kernels/box_scan.py", "box_scan_pallas"):
        ("kernels/box_scan.py", "box_scan", _KERNEL),
    ("kernels/box_scan.py", "box_scan_seg_pallas"):
        ("kernels/box_scan.py", "box_scan_seg", _KERNEL),
    ("kernels/l2dist.py", "l2dist_pallas"):
        ("kernels/l2dist.py", "l2dist", _KERNEL),
    ("kernels/flash_attention.py", "flash_attention_pallas"):
        ("kernels/flash_attention.py", "flash_attention", _KERNEL),
}

_HLO = ("parses XLA's HLO text; the port prices a trace of torch ops "
        "(hlo_analysis.OpTrace), so there is no HLO to read")
_PYTREE = ("a typing alias for JAX pytrees; the port's parameters and "
           "states are dicts of tensors and modules, typed as such")
# (module, reference name) -> reason; module "*" for any module
NOT_PORTED = {
    ("compat.py", "shard_map"):
        "jax.shard_map's version shim; the port's mesh code places "
        "DTensors and calls its collectives itself (models/common.py)",
    ("launch/hlo_analysis.py", "parse_hlo"): _HLO,
    ("launch/hlo_analysis.py", "Instr"): _HLO,
    ("launch/hlo_analysis.py", "Computation"): _HLO,
    ("launch/hlo_analysis.py", "trip_count"): _HLO,
    ("launch/dryrun.py", "collective_stats"):
        "reads collectives from XLA's HLO text; the port counts them from "
        "its op trace",
    ("launch/dryrun.py", "memory_dict"):
        "reads XLA's compiled memory statistics; the port measures the "
        "trace's live storages",
    ("launch/specs.py", "get_config_like"):
        "an identity hook of the reference's jax.eval_shape specs; the "
        "port's specs take the config itself",
    ("models/common.py", "stacked"):
        "jax.vmap of an init over stacked PRNG keys; the port draws each "
        "layer from its torch.Generator",
    ("kernels/flash_attention.py", "NEG_INF"):
        "the Pallas body's mask fill; the CUDA kernels hold it as "
        "csrc/hopper.cuh's kMasked and the plain version as a literal",
    ("*", "PyTree"): _PYTREE,
}


def _public(path: Path) -> set:
    """The reference module's public names: top-level functions, classes
    and assigned names, public methods as "Class.method", and
    "__all__:name" for each entry of __all__."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
        for name in _assigned(node):
            if name == "__all__":
                out |= {f"__all__:{e.value}" for e in node.value.elts}
            elif not name.startswith("_"):
                out.add(name)
    return out


def _assigned(node) -> list:
    targets = (node.targets if isinstance(node, ast.Assign) else
               [node.target] if isinstance(node, ast.AnnAssign) else [])
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _defined(path: Path) -> set:
    """Every name the port's module binds at top level (definitions,
    imports, assignments, also under if / try), its classes' methods as
    "Class.method", and "__all__:name" for each entry of __all__."""
    out = set()
    todo = list(ast.parse(path.read_text()).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.If, ast.Try)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            for h in getattr(node, "handlers", []):
                todo += h.body
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
        else:
            for name in _assigned(node):
                out.add(name)
                if name == "__all__":
                    out |= {f"__all__:{e.value}" for e in node.value.elts}
    return out


def _not_ported(module: str, name: str):
    return NOT_PORTED.get((module, name), NOT_PORTED.get(("*", name)))


@pytest.mark.parametrize("module", MODULES)
def test_port_has_every_public_name(module):
    port = PORT / module
    assert port.exists(), f"src/repro_torch/{module} is missing"
    ref_names, have = _public(REF / module), _defined(port)
    missing = []
    for name in sorted(ref_names):
        if (module, name) in RENAMED:
            mod, new, reason = RENAMED[(module, name)]
            assert reason
            assert new in _defined(PORT / mod), (
                f"{module}:{name} is renamed to {mod}:{new}, which the "
                f"port lacks")
        elif _not_ported(module, name):
            assert name not in have, (
                f"{module}:{name} is listed as not ported but the port "
                f"has it: drop it from NOT_PORTED")
        elif name not in have:
            missing.append(name)
    assert not missing, f"src/repro_torch/{module} lacks {missing}"
    # every list entry of this module names a reference name
    stale = [n for (m, n) in [*RENAMED, *NOT_PORTED]
             if m == module and n not in ref_names]
    assert not stale, f"RENAMED / NOT_PORTED entries of {module} name " \
                      f"nothing in the reference: {stale}"
