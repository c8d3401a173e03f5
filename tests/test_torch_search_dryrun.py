"""The port's search dry run (``launch/search_dryrun.py``) against the
reference's ``run_variant``, run in one subprocess with 512 fake CPU
devices (``XLA_FLAGS`` set before JAX is imported; its ``ART_DIR``
pointed under ``tmp_path``, since it writes its HLO even with
``save=False``): index_query and full_scan on the 16 x 16 and 2 x 16 x 16
meshes at 2^20 rows, index_query in bfloat16, and at 2^24 rows with a
selectivity of 0.5 (a capacity above the floor of 8). The reference's
geometry and kernel model are equal: ``capacity_blocks``,
``rows_per_device``, ``shard_bytes``, ``kernel_model_bytes_per_device``
and ``kernel_model_flops_per_device``.

Also: the traced step is one shard's ``pruned_local_step`` (one
zone_candidates call, one box_scan_pruned call, no collective), its
kernels' bytes the kernel model's with every block's counts written in
place of the capacity's, plus the boxes each reads and the candidate
list written and read; run for real on the CPU, the pruned step's counts
are the unpruned local counts (zone_hits + box_scan) where no shard
overflows, and the full scan's are box_scan_ref's; the CLI's ``--all``
and ``reanalyze`` exit 0 under ``tmp_path``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core.index import distributed_query, pruned_local_step
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun, reanalyze, search_dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (variant, n_rows, multi_pod, dtype, selectivity)
CASES = (("index_query", 2 ** 20, False, "float32", 0.02),
         ("full_scan", 2 ** 20, False, "float32", 0.02),
         ("index_query", 2 ** 20, True, "float32", 0.02),
         ("full_scan", 2 ** 20, True, "float32", 0.02),
         ("index_query", 2 ** 20, False, "bfloat16", 0.02),
         ("index_query", 2 ** 24, False, "float32", 0.5))
FIELDS = ("capacity_blocks", "rows_per_device", "shard_bytes",
          "kernel_model_bytes_per_device", "kernel_model_flops_per_device")

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import pathlib
import jax.numpy as jnp
from repro.launch import search_dryrun
search_dryrun.ART_DIR = pathlib.Path(ART_DIR)
out = []
for variant, n_rows, multi_pod, dtype, sel in CASES:
    kw = (dict(d_sub=384, n_boxes=128) if variant == "full_scan" else {})
    r = search_dryrun.run_variant(variant, n_rows=n_rows,
                                  multi_pod=multi_pod, selectivity=sel,
                                  save=False, dtype=jnp.dtype(dtype), **kw)
    assert r["ok"], r.get("error")
    out.append({k: r[k] for k in FIELDS})
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    art = tmp_path_factory.mktemp("reference_search")
    prog = (f"CASES = {CASES!r}\nFIELDS = {FIELDS!r}\nART_DIR = "
            f"{str(art)!r}\n" + textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    for line in out.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(out.stdout[-2000:])


def _port(case, art_dir):
    variant, n_rows, multi_pod, dtype, sel = case
    kw = dict(search_dryrun.FULL_SCAN) if variant == "full_scan" else {}
    return search_dryrun.run_variant(
        variant, n_rows=n_rows, multi_pod=multi_pod, selectivity=sel,
        dtype=getattr(torch, dtype), art_dir=art_dir, **kw)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_search_fields_equal_the_reference(i, reference, tmp_path):
    got = _port(CASES[i], tmp_path)
    assert got["ok"], got.get("error")
    assert {k: got[k] for k in FIELDS} == reference[i]


def test_index_query_traces_one_shards_pruned_step(tmp_path):
    r = _port(CASES[0], tmp_path)
    cap, block, d, n_boxes = r["capacity_blocks"], 1024, 6, 32
    nb_loc = r["shard_bytes"] // (block * d * 4)
    assert {k: v["calls"] for k, v in r["kernels"].items()} == {
        "zone_candidates": 1, "box_scan_pruned": 1}
    assert r["collectives"] == {} and r["collective_bytes_per_device"] == 0
    boxes = 2 * n_boxes * d * 4
    # the kernel model writes the capacity's counts; box_scan_pruned
    # writes every block's once, and reads cand and n_hit beside the
    # boxes, as zone_candidates writes them
    assert sum(v["bytes"] for v in r["kernels"].values()) \
        == (r["kernel_model_bytes_per_device"] - cap * block * 4
            + nb_loc * block * 4 + 2 * boxes + 2 * (4 * cap + 4))
    assert r["memory"]["argument_bytes"] \
        == r["shard_bytes"] + 2 * nb_loc * d * 4 + boxes
    assert r["memory"]["output_bytes"] == nb_loc * block * 4
    name = "search-index_query_pod1_16x16"
    assert json.loads((tmp_path / f"{name}.json").read_text())["ok"]
    assert (tmp_path / (name + dryrun.TRACE_SUFFIX)).exists()


def _catalog(nb: int, block: int, d: int, n_boxes: int, seed: int):
    """Rows whose dim 0 rises with the block (tight zone maps), boxes
    narrow in dim 0: few blocks survive the prune."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.rand((nb, block, d), generator=g)
    rows[..., 0] = (torch.arange(nb)[:, None] + torch.rand(
        (nb, block), generator=g)) / nb
    lo = torch.rand((n_boxes, d), generator=g) * 0.3
    hi = lo + 0.6
    lo[:, 0] = torch.rand(n_boxes, generator=g) * 0.9
    hi[:, 0] = lo[:, 0] + 2.0 / nb
    return rows, rows.amin(1), rows.amax(1), lo, hi


def test_local_steps_on_the_cpu_equal_the_unpruned_counts():
    nb, block, d = 256, 64, 6
    rows, zlo, zhi, lo, hi = _catalog(nb, block, d, n_boxes=8, seed=3)
    cap = search_dryrun.geometry(nb * block, block, 1, 0.2)[2]
    hit = kref.zone_hits_ref(zlo, zhi, lo, hi)
    assert 0 < int(hit.sum()) <= cap
    got = pruned_local_step(block, cap)(
        rows, zlo, zhi, lo, hi)
    want = distributed_query(rows, zlo, zhi, lo, hi, ["cpu"], block)
    assert torch.equal(got, want) and int(got.sum()) > 0
    full = search_dryrun.make_full_scan_step()(rows, lo, hi)
    assert torch.equal(full, kref.box_scan_ref(rows.reshape(-1, d), lo, hi))


def test_cli_all_and_reanalyze(tmp_path, capsys):
    assert search_dryrun.main(["--all", "--art-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("[ok] search/") == 2
    for v in ("index_query", "full_scan"):
        d = json.loads((tmp_path / f"search-{v}_pod1_16x16.json")
                       .read_text())
        assert d["ok"] and d["devices"] == 256
    assert d["shard_bytes"] == 5520 * 1024 * 384 * 4 // 16
    assert reanalyze.main(["--art-dir", str(tmp_path)]) == 0
    assert "updated=2 skipped(no trace)=0" in capsys.readouterr().out
