"""The port's durable live catalog against the reference's, on the CPU.

The port's ``core/persist.py``, the durable half of its
``SegmentedCatalog`` and the engine's ``data_dir`` / ``wal_sync`` /
``faults`` are held to ``repro``'s. Every test of tests/test_durability.py
has a twin here of the same name (the two serve-layer ones through each
package's ``QueryServer``): the same seeded mutation script and the same crash spec run
through both packages (the port with ``device="cpu"``), each package's
own assertions hold, and then the two are held to each other — the
recovered snapshots bitwise (features, validity, frange, epoch, every
segment's perm / rows / zlo / zhi), the recovery reports' counters, and
at the engine level ranked ids and scores.

The cross-package tests recover a directory written by one package in
the other (crash matrix, torn tails, compaction crash points) and hold
the files of one script written by both byte for byte.

POSIX record locks belong to the process, so in one process the two
packages' ``DirLock`` do not see each other: a directory is closed (or
its catalog dropped) by one package before the other opens it, and the
single-writer twin checks the port against a child process that imports
only ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import errors as jerrors
from repro.core import persist as jpersist
from repro.core.engine import SearchEngine as JaxEngine
from repro.core.segments import SegmentedCatalog as JaxCatalog
from repro.core.subsets import make_subsets as jax_make_subsets
from repro.serve import engine as jserve
from repro.serve import faults as jfaults
from repro_torch.core import SearchEngine
from repro_torch.core import errors as terrors
from repro_torch.core import persist as tpersist
from repro_torch.core.segments import SegmentedCatalog
from repro_torch.core.subsets import make_subsets
from repro_torch.serve import engine as tserve
from repro_torch.serve import faults as tfaults

D, BLOCK = 16, 64
ENG = dict(n_subsets=4, subset_dim=4, block=BLOCK, seed=0)
ROOT = Path(__file__).resolve().parent.parent


def _data(n=200, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, D)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's durable-catalog surface; the port's entry points get
    ``device="cpu"``."""
    name: str
    persist: object
    errors: object
    faults: object
    Catalog: type
    Engine: type
    subsets: np.ndarray
    kw: tuple = ()

    def fresh(self, x, persist_dir=None, **kw):
        return self.Catalog(x, self.subsets, block=BLOCK,
                            persist_dir=persist_dir, **dict(self.kw), **kw)

    def open(self, d, **kw):
        return self.Catalog.open(d, **dict(self.kw), **kw)

    def engine(self, x=None, **kw):
        return self.Engine(x, **ENG, **dict(self.kw), **kw)

    def inj(self, site, action, **kw):
        return self.faults.FaultInjector(
            specs=[self.faults.FaultSpec(site, action, **kw)])


REF = Pkg("repro", jpersist, jerrors, jfaults, JaxCatalog, JaxEngine,
          jax_make_subsets(D, 4, 4, seed=0))
PORT = Pkg("repro_torch", tpersist, terrors, tfaults, SegmentedCatalog,
           SearchEngine, make_subsets(D, 4, 4, seed=0),
           kw=(("device", "cpu"),))
PKGS = (REF, PORT)

# the reference test's script: every entry is effective (appends are
# non-empty, deletes hit live rows), so mutation j is WAL record j / LSN j
MUTATIONS = [
    ("append", _data(30, seed=1)),
    ("delete", [5, 6, 7]),
    ("append", _data(12, seed=2)),
    ("delete", [0, 205, 231]),
    ("append", _data(50, seed=3)),
    ("delete", [100, 240]),
]


def _apply(cat, muts):
    for op, arg in muts:
        (cat.append if op == "append" else cat.delete)(arg)


def _assert_same_state(a, b):
    """Bitwise snapshot equality: everything a query reads (the reference
    test's helper; ``a`` and ``b`` may come from either package)."""
    sa, sb = a.snapshot(), b.snapshot()
    assert sa.epoch == sb.epoch
    assert sa.n == sb.n and sa.live_rows == sb.live_rows
    np.testing.assert_array_equal(sa.x[:sa.n], sb.x[:sb.n])
    np.testing.assert_array_equal(sa.valid_host[:sa.n],
                                  sb.valid_host[:sb.n])
    np.testing.assert_array_equal(sa.frange, sb.frange)
    assert len(sa.segments) == len(sb.segments)
    for ga, gb in zip(sa.segments, sb.segments):
        assert (ga.offset, ga.n_rows, ga.shard) == \
               (gb.offset, gb.n_rows, gb.shard)
        for ia, ib in zip(ga.indexes, gb.indexes):
            np.testing.assert_array_equal(ia.perm, ib.perm)
            np.testing.assert_array_equal(ia.rows, ib.rows)
            np.testing.assert_array_equal(ia.zlo, ib.zlo)
            np.testing.assert_array_equal(ia.zhi, ib.zhi)
            np.testing.assert_array_equal(ia.dims, ib.dims)


def _same_catalogs(a, b):
    """The cross-package check: the same snapshot, geometry generation,
    LSN and shard cursor."""
    _assert_same_state(a, b)
    assert a.snapshot().geom == b.snapshot().geom
    assert a._lsn == b._lsn and a._next_shard == b._next_shard


def _report(rep) -> dict:
    """A RecoveryReport's fields but its wall time."""
    out = dataclasses.asdict(rep)
    out.pop("wall_s")
    return out


def _same_results(a, b):
    """Ranked ids and scores bitwise, and every integer stat equal."""
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    for k, v in a.stats.items():
        if isinstance(v, (bool, int, np.integer, str)) and k in b.stats:
            assert b.stats[k] == v, k


def _oracles(P):
    """The fault-free catalogs after 0 .. len(MUTATIONS) mutations."""
    out = [P.fresh(_data())]
    for j in range(len(MUTATIONS)):
        o = P.fresh(_data())
        _apply(o, MUTATIONS[:j + 1])
        out.append(o)
    return out


def _wal_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("wal-"))


# ----------------------------------------------------------------------
# WAL codec + helpers
# ----------------------------------------------------------------------

def test_wal_record_roundtrip():
    feats = _data(7, seed=3)
    for P in PKGS:
        rec = P.persist.decode_record(P.persist.encode_append(11, feats))
        assert rec.op == "append" and rec.lsn == 11
        np.testing.assert_array_equal(rec.features, feats)
        rec = P.persist.decode_record(
            P.persist.encode_delete(12, [3, 9, 2**40]))
        assert rec.op == "delete" and rec.lsn == 12
        np.testing.assert_array_equal(rec.ids, [3, 9, 2**40])
    # the record layout is the reference's, byte for byte
    assert tpersist.encode_append(11, feats) == \
        jpersist.encode_append(11, feats)
    assert tpersist.encode_delete(12, [3, 9, 2**40]) == \
        jpersist.encode_delete(12, [3, 9, 2**40])
    rec = tpersist.decode_record(jpersist.encode_append(11, feats))
    np.testing.assert_array_equal(rec.features, feats)


def test_checksum_rejects_unavailable_algo():
    for P in PKGS:
        assert P.persist.checksum(b"abc") == P.persist.checksum(b"abc")
        assert P.persist.checksum(b"abc") != P.persist.checksum(b"abd")
        with pytest.raises(P.errors.PersistenceError):
            P.persist.checksum(b"abc", algo="no-such-algo")
    # the same algorithm on this host, and the same sums under each
    assert tpersist.DEFAULT_ALGO == jpersist.DEFAULT_ALGO
    assert tpersist.WAL_MAGIC == jpersist.WAL_MAGIC
    for blob in (b"", b"abc", bytes(range(256)) * 7):
        assert tpersist.checksum(blob) == jpersist.checksum(blob)
        assert tpersist.checksum(blob, "crc32-zlib") == \
            jpersist.checksum(blob, "crc32-zlib")


def test_atomic_write_bytes_never_leaves_partials():
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "f.bin")
            P.persist.atomic_write_bytes(p, b"v1")
            assert open(p, "rb").read() == b"v1"
            P.persist.atomic_write_bytes(p, b"v2-longer")
            assert open(p, "rb").read() == b"v2-longer"
            assert os.listdir(d) == ["f.bin"]             # no tmp litter


def test_has_state_and_constructor_refuses_existing_dir():
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            assert not P.persist.has_state(d)
            cat = P.fresh(_data(), persist_dir=d)
            cat.close()
            assert P.persist.has_state(d)
            with pytest.raises(P.errors.PersistenceError, match="open"):
                P.fresh(_data(), persist_dir=d)
    # a directory the reference wrote is state to the port too
    with tempfile.TemporaryDirectory() as d:
        REF.fresh(_data(), persist_dir=d).close()
        assert tpersist.has_state(d)
        with pytest.raises(terrors.PersistenceError, match="open"):
            PORT.fresh(_data(), persist_dir=d)


# ----------------------------------------------------------------------
# clean round trip
# ----------------------------------------------------------------------

def test_reopen_is_bitwise_identical_after_clean_close():
    got = {}
    for P in PKGS:
        oracle = P.fresh(_data())
        _apply(oracle, MUTATIONS)
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS)
            cat.close()
            re = P.open(d)
            assert re.recovery.clean
            assert re.recovery.replayed_appends \
                + re.recovery.replayed_deletes == len(MUTATIONS)
            _assert_same_state(re, oracle)
            assert re.stats()["durable"]["sync"] == "batch"
            re.close()
        got[P.name] = re
    _same_catalogs(got["repro"], got["repro_torch"])
    assert _report(got["repro"].recovery) == \
        _report(got["repro_torch"].recovery)
    dj, dt = (got[n].stats()["durable"] for n in ("repro", "repro_torch"))
    assert set(dj) == set(dt)
    assert {k: v for k, v in dj.items() if k != "wal_sync_s"} == \
        {k: v for k, v in dt.items() if k != "wal_sync_s"}


def test_reopen_without_close_recovers_batch_sync():
    """sync="batch" flushes per record: dropping the catalog without
    close() still recovers everything, in both packages alike."""
    got = {}
    for P in PKGS:
        oracle = P.fresh(_data())
        _apply(oracle, MUTATIONS)
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS)
            del cat                         # no close, no final fsync
            re = P.open(d)
            assert re.recovery.clean
            _assert_same_state(re, oracle)
            re.close()
        got[P.name] = re
    _same_catalogs(got["repro"], got["repro_torch"])


def test_checkpoint_truncates_replay():
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS[:4])
            ck = cat.checkpoint()
            assert (ck["epoch"], ck["lsn"], ck["segments"]) == (4, 4, 3)
            _apply(cat, MUTATIONS[4:])
            cat.close()
            re = P.open(d)
            assert re.recovery.clean
            assert re.recovery.replayed_appends \
                + re.recovery.replayed_deletes == len(MUTATIONS) - 4
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            _assert_same_state(re, oracle)
            re.close()
        got[P.name] = re
    _same_catalogs(got["repro"], got["repro_torch"])
    assert _report(got["repro"].recovery) == \
        _report(got["repro_torch"].recovery)


def test_mutations_after_recovery_continue_the_log():
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS[:3])
            cat.close()
            re = P.open(d)
            _apply(re, MUTATIONS[3:])
            re.close()
            re2 = P.open(d)
            assert re2.recovery.clean
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            _assert_same_state(re2, oracle)
            re2.close()
            got[P.name] = (re2, sorted(os.listdir(d)))
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert _report(got["repro"][0].recovery) == \
        _report(got["repro_torch"][0].recovery)
    assert got["repro"][1] == got["repro_torch"][1]    # the same files


# ----------------------------------------------------------------------
# the crash matrix: every WAL record boundary
# ----------------------------------------------------------------------

def test_crash_after_every_durable_record_recovers_that_record():
    """Kill between WAL append and snapshot swap at EVERY record: the
    logged mutation is durable, so recovery lands on the oracle that
    applied it — in both packages, and the two recoveries agree."""
    oracles = {P.name: _oracles(P) for P in PKGS}
    for j in range(1, len(MUTATIONS) + 1):
        got = {}
        for P in PKGS:
            inj = P.inj("wal_commit", "crash", at_calls=(j,))
            with tempfile.TemporaryDirectory() as d:
                cat = P.fresh(_data(), persist_dir=d, faults=inj)
                with pytest.raises(P.errors.InjectedCrash):
                    _apply(cat, MUTATIONS)
                del cat                      # the "process" is dead
                re = P.open(d)
                assert re.recovery.clean     # boundary crash = no damage
                _assert_same_state(re, oracles[P.name][j])
                re.close()
            got[P.name] = re
        _same_catalogs(got["repro"], got["repro_torch"])
        assert _report(got["repro"].recovery) == \
            _report(got["repro_torch"].recovery)


@pytest.mark.parametrize("fraction", [0.0, 0.3, 0.9])
def test_torn_record_at_every_boundary_salvages_prefix(fraction):
    """Tear EVERY record mid-write: recovery excludes the torn record,
    reports the torn tail and quarantines the refused bytes; the salvage
    equals the oracle one mutation behind, and the two packages' reports
    (errors, quarantined names, counters) are equal."""
    oracles = {P.name: _oracles(P) for P in PKGS}
    for j in range(1, len(MUTATIONS) + 1):
        got = {}
        for P in PKGS:
            inj = P.inj("wal_write", "torn", at_calls=(j,),
                        fraction=fraction)
            with tempfile.TemporaryDirectory() as d:
                cat = P.fresh(_data(), persist_dir=d, faults=inj)
                with pytest.raises(P.errors.InjectedCrash):
                    _apply(cat, MUTATIONS)
                del cat
                if fraction == 0.0:
                    re = P.open(d)
                    assert re.recovery.clean
                else:
                    with pytest.raises(P.errors.RecoveryError) as ei:
                        P.open(d)
                    assert ei.value.report.torn_tail
                    assert ei.value.report.quarantined
                    re = ei.value.catalog
                    assert re is not None
                    assert not re.recovery.clean
                _assert_same_state(re, oracles[P.name][j - 1])
                re.close()
                got[P.name] = (re, sorted(os.listdir(
                    os.path.join(d, "quarantine")))
                    if fraction else [])
        _same_catalogs(got["repro"][0], got["repro_torch"][0])
        assert _report(got["repro"][0].recovery) == \
            _report(got["repro_torch"][0].recovery)
        assert got["repro"][1] == got["repro_torch"][1]


def _engine_crash_run(P, muts, j, x, qkw, pos, neg):
    """A durable engine crashed at wal_commit call j, recovered with
    features=None: the recovered engine's result, and the recovery."""
    inj = P.inj("wal_commit", "crash", at_calls=(j,))
    with tempfile.TemporaryDirectory() as d:
        eng = P.engine(x.copy(), live=True, data_dir=d, faults=inj)
        with pytest.raises(P.errors.InjectedCrash):
            for op, arg in muts:
                (eng.append if op == "append" else eng.delete)(arg)
        del eng
        re = P.engine(live=True, data_dir=d)
        assert re.recovery.clean
        got = re.query(pos, neg, **qkw)
        re.close()
    return got, re


def test_engine_ranked_results_bitwise_across_crash():
    """Ranked ids AND scores of a recovered engine are bitwise those of a
    never-crashed one, at the first, a middle and the last boundary — in
    each package, and the port's equal the reference's."""
    pos, neg = list(range(8)), list(range(100, 140))
    qkw = dict(model="dbranch", n_models=3, seed=7)
    for j in (1, 3, len(MUTATIONS)):
        got = {}
        for P in PKGS:
            oracle_eng = P.engine(_data(), live=True)
            for op, arg in MUTATIONS[:j]:
                (oracle_eng.append if op == "append"
                 else oracle_eng.delete)(arg)
            want = oracle_eng.query(pos, neg, **qkw)
            res, re = _engine_crash_run(P, MUTATIONS, j, _data(), qkw,
                                        pos, neg)
            np.testing.assert_array_equal(want.ids, res.ids)
            np.testing.assert_array_equal(want.scores, res.scores)
            got[P.name] = (res, re)
        _same_results(got["repro"][0], got["repro_torch"][0])
        _same_catalogs(got["repro"][1]._catalog,
                       got["repro_torch"][1]._catalog)


def test_engine_crash_parity_with_ties_and_tombstones():
    """Crash parity where it bites hardest: duplicated rows force
    kth-score TIES at the ranked cut and deletes put tombstones in both
    the checkpointed base and the replayed tail."""
    x = _data(220)
    x[50:60] = x[40:50]              # duplicate rows -> kth-score ties
    dup = _data(30, seed=4)
    dup[10:20] = x[40:50]            # appended duplicates of base rows
    muts = [("append", dup), ("delete", [41, 45]),
            ("append", x[44:54].copy()), ("delete", [52, 225])]
    pos, neg = list(range(36, 44)), list(range(120, 160))
    qkw = dict(model="dbranch", n_models=3, seed=7, max_results=25)
    got = {}
    for P in PKGS:
        oracle = P.engine(x.copy(), live=True)
        for op, arg in muts[:3]:
            (oracle.append if op == "append" else oracle.delete)(arg)
        want = oracle.query(pos, neg, **qkw)
        res, _ = _engine_crash_run(P, muts, 3, x, qkw, pos, neg)
        np.testing.assert_array_equal(want.ids, res.ids)
        np.testing.assert_array_equal(want.scores, res.scores)
        assert not set(res.ids) & {41, 45}
        got[P.name] = res
    _same_results(got["repro"], got["repro_torch"])


# ----------------------------------------------------------------------
# compaction's two-phase commit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("site,call", [
    ("compact", 1),          # before the merge: nothing changed
    ("segment_write", 2),    # phase 1, mid-checkpoint: orphan files
    ("manifest_commit", 2),  # phase 2, before the flip: orphan segments
])
def test_compaction_crash_points_recover_query_identical(site, call):
    """Crash a durable compaction at each phase: recovery lands on the
    logical pre-compaction catalog in both packages, and the two
    recoveries are the same state with the same report."""
    got = {}
    for P in PKGS:
        oracle = P.fresh(_data())
        _apply(oracle, MUTATIONS)
        inj = P.inj(site, "crash", at_calls=(call,))
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d, faults=inj)
            _apply(cat, MUTATIONS)
            with pytest.raises(P.errors.InjectedCrash):
                cat.compact()
            del cat
            re = P.open(d)
            assert re.recovery.clean
            sa, sb = re.snapshot(), oracle.snapshot()
            assert sa.n == sb.n and sa.live_rows == sb.live_rows
            np.testing.assert_array_equal(sa.x[:sa.n], sb.x[:sb.n])
            np.testing.assert_array_equal(sa.valid_host[:sa.n],
                                          sb.valid_host[:sb.n])
            for name in os.listdir(d):
                assert not name.endswith(".tmp")
            re.close()
            got[P.name] = (re, sorted(os.listdir(d)))
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert _report(got["repro"][0].recovery) == \
        _report(got["repro_torch"][0].recovery)
    assert got["repro"][1] == got["repro_torch"][1]


def test_compaction_completed_then_crash_before_nothing_else():
    """A compaction whose manifest DID land survives reopen: the merged
    segment set is what recovery loads (epoch included)."""
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS)
            cat.compact()
            epoch = cat.epoch
            del cat                 # crash AFTER the 2PC completed
            re = P.open(d)
            assert re.recovery.clean and re.epoch == epoch
            assert len(re.snapshot().segments) == 1
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            oracle.compact()
            _assert_same_state(re, oracle)
            re.close()
        got[P.name] = re
    _same_catalogs(got["repro"], got["repro_torch"])


# ----------------------------------------------------------------------
# header-only WAL files: reopen must append, never re-write the header
# ----------------------------------------------------------------------

def test_reopen_after_header_only_wal_preserves_acked_records():
    """A crash between the WAL header write and the first record leaves
    a header-only file that recovers clean; the reopened catalog appends
    after that header, never writes a second one."""
    got = {}
    for P in PKGS:
        inj = P.inj("wal_write", "torn", at_calls=(1,), fraction=0.0)
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d, faults=inj)
            with pytest.raises(P.errors.InjectedCrash):
                cat.append(_data(10, seed=1))
            del cat
            re = P.open(d)
            assert re.recovery.clean
            _apply(re, MUTATIONS)
            re.close()
            re2 = P.open(d)
            assert re2.recovery.clean and not re2.recovery.quarantined
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            _assert_same_state(re2, oracle)
            blob = open(os.path.join(d, _wal_files(d)[0]), "rb").read()
            assert blob.count(P.persist.WAL_MAGIC) == 1
            re2.close()
        got[P.name] = (re2, blob)
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert got["repro"][1] == got["repro_torch"][1]    # the same WAL bytes


def test_rolled_back_first_append_then_clean_close_keeps_later_records():
    """The first append's fsync fails (sync="always"), the record rolls
    back to the bare header, the catalog closes cleanly; mutations after
    reopen land in that file and survive the next reopen."""
    got = {}
    for P in PKGS:
        inj = P.inj("wal_fsync", "fail", at_calls=(1,))
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d, faults=inj, sync="always")
            with pytest.raises(P.errors.PersistenceError):
                cat.append(_data(10, seed=1))
            cat.close()
            re = P.open(d, sync="always")
            assert re.recovery.clean
            re.append(_data(10, seed=1))
            re.delete([3, 4])
            re.close()
            re2 = P.open(d)
            assert re2.recovery.clean
            assert re2.recovery.replayed_appends == 1
            assert re2.recovery.replayed_deletes == 1
            assert re2.snapshot().n == 210
            re2.close()
        got[P.name] = re2
    _same_catalogs(got["repro"], got["repro_torch"])


def test_open_wal_refuses_mismatched_existing_header():
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            p = P.persist.Persistence(d)
            with open(os.path.join(d, "wal-000000000001.log"), "wb") as f:
                f.write(b"not-a-wal-header")
            with pytest.raises(P.errors.PersistenceError, match="header"):
                p.log_append(1, _data(2))
            p.close()


# ----------------------------------------------------------------------
# single-writer lock: one process per data_dir
# ----------------------------------------------------------------------

_LOCK_CHILD = textwrap.dedent("""
    import sys
    from repro_torch.core import persist
    from repro_torch.core.errors import PersistenceError
    assert "jax" not in sys.modules and "repro" not in sys.modules
    want = sys.argv[2]
    try:
        p = persist.Persistence(sys.argv[1])
    except PersistenceError:
        sys.exit(0 if want == "locked" else 2)
    p.close()
    sys.exit(0 if want == "acquired" else 3)
""")


def _run_lock_child(d, want):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", _LOCK_CHILD, d, want],
                          capture_output=True, env=env, cwd=ROOT)


def test_data_dir_single_writer_enforced_across_processes():
    """While this process holds a port catalog, a child process running
    only ``repro_torch`` fails with a typed PersistenceError; after
    close() the directory is free again, and this process reopens it."""
    if tpersist.fcntl is None:
        pytest.skip("no fcntl on this platform")
    with tempfile.TemporaryDirectory() as d:
        cat = PORT.fresh(_data(), persist_dir=d)
        out = _run_lock_child(d, "locked")
        assert out.returncode == 0, (out.returncode, out.stderr.decode())
        cat.close()
        out = _run_lock_child(d, "acquired")
        assert out.returncode == 0, (out.returncode, out.stderr.decode())
        re = PORT.open(d)
        assert re.recovery.clean
        re.close()


# ----------------------------------------------------------------------
# failed-fsync rollback + poisoned log
# ----------------------------------------------------------------------

def test_fsync_failure_rolls_back_record_and_lsn():
    """sync="always" + a failing fsync: the record is truncated off the
    log AND its LSN released, so the log continues gap-free."""
    got = {}
    for P in PKGS:
        inj = P.inj("wal_fsync", "fail", at_calls=(2,))
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d, faults=inj, sync="always")
            cat.append(_data(10, seed=1))
            with pytest.raises(P.errors.PersistenceError):
                cat.append(_data(5, seed=2))
            assert cat.snapshot().n == 210          # memory unchanged
            assert cat.persist.stats["wal_rollbacks"] == 1
            assert cat._lsn == 1
            cat.append(_data(7, seed=3))            # log continues gap-free
            cat.close()
            re = P.open(d)
            assert re.recovery.clean and re.snapshot().n == 217
            assert re.recovery.last_lsn == 2
            re.close()
        got[P.name] = re
    _same_catalogs(got["repro"], got["repro_torch"])
    assert _report(got["repro"].recovery) == \
        _report(got["repro_torch"].recovery)


# ----------------------------------------------------------------------
# corruption detection: flipped bytes, damaged manifests
# ----------------------------------------------------------------------

def test_corrupt_wal_byte_quarantines_suffix():
    """Flip one byte in the MIDDLE of the log: the prefix replays, the
    rest is refused and quarantined, and the failure is a typed
    RecoveryError carrying the salvage — the same in both packages."""
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS)
            cat.close()
            p = os.path.join(d, _wal_files(d)[0])
            blob = bytearray(open(p, "rb").read())
            blob[len(blob) // 2] ^= 0xFF
            with open(p, "wb") as f:
                f.write(blob)
            with pytest.raises(P.errors.RecoveryError) as ei:
                P.open(d)
            rep = ei.value.report
            assert rep.quarantined and not rep.clean
            salv = ei.value.catalog
            assert salv is not None
            replayed = rep.replayed_appends + rep.replayed_deletes
            assert 0 <= replayed < len(MUTATIONS)
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS[:replayed])
            _assert_same_state(salv, oracle)
            salv.close()
            re = P.open(d, strict=False)
            _assert_same_state(re, oracle)
            re.close()
        got[P.name] = (salv, rep)
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert _report(got["repro"][1]) == _report(got["repro_torch"][1])


def test_corrupt_newest_manifest_falls_back_to_older():
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS[:3])
            cat.checkpoint()
            _apply(cat, MUTATIONS[3:])
            cat.close()
            mans = sorted(f for f in os.listdir(d)
                          if f.startswith("manifest-"))
            assert len(mans) == 2
            with open(os.path.join(d, mans[-1]), "r+b") as f:
                f.write(b"\x00garbage\x00")
            with pytest.raises(P.errors.RecoveryError) as ei:
                P.open(d)
            re = ei.value.catalog
            assert re is not None
            assert any(mans[-1] in q for q in ei.value.report.quarantined)
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            _assert_same_state(re, oracle)
            re.close()
        got[P.name] = (re, ei.value.report)
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert _report(got["repro"][1]) == _report(got["repro_torch"][1])


def test_orphaned_complete_segments_quarantined_not_deleted():
    """Segment dirs referenced only by a manifest that failed validation
    are quarantined, meta-less dirs deleted — the same dirs in both
    packages."""
    got = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS[:3])
            cat.checkpoint()
            _apply(cat, MUTATIONS[3:])
            cat.close()
            mans = sorted(f for f in os.listdir(d)
                          if f.startswith("manifest-"))
            with open(os.path.join(d, mans[-1])) as f:
                newest = json.load(f)
            with open(os.path.join(d, mans[0])) as f:
                oldest = json.load(f)
            only_new = ({e["dir"] for e in newest["segments"]}
                        - {e["dir"] for e in oldest["segments"]})
            assert only_new
            os.makedirs(os.path.join(d, "seg-0000009999"))
            with open(os.path.join(d, mans[-1]), "r+b") as f:
                f.write(b"\x00garbage\x00")
            with pytest.raises(P.errors.RecoveryError) as ei:
                P.open(d)
            rep = ei.value.report
            for name in only_new:
                assert not os.path.exists(os.path.join(d, name))
                qdir = os.path.join(d, "quarantine", name)
                assert os.path.isfile(os.path.join(qdir, "meta.json"))
                assert any(name in q for q in rep.quarantined)
            assert rep.orphans_removed == ["seg-0000009999"]
            assert not os.path.exists(os.path.join(d, "seg-0000009999"))
            oracle = P.fresh(_data())
            _apply(oracle, MUTATIONS)
            _assert_same_state(ei.value.catalog, oracle)
            ei.value.catalog.close()
        got[P.name] = (ei.value.catalog, rep, sorted(only_new))
    _same_catalogs(got["repro"][0], got["repro_torch"][0])
    assert _report(got["repro"][1]) == _report(got["repro_torch"][1])
    assert got["repro"][2] == got["repro_torch"][2]


def test_empty_dir_and_destroyed_dir_raise_typed_errors():
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(P.errors.RecoveryError):
                P.open(d)
            cat = P.fresh(_data(), persist_dir=d)
            cat.close()
            for f in os.listdir(d):
                if f.startswith("manifest-"):
                    os.unlink(os.path.join(d, f))
            with pytest.raises(P.errors.RecoveryError) as ei:
                P.open(d)
            assert ei.value.catalog is None
            assert ei.value.report.manifest_id == -1


# ----------------------------------------------------------------------
# the real thing: SIGKILL mid-ingest in a subprocess
# ----------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import sys, numpy as np
    from repro_torch.core.segments import SegmentedCatalog
    from repro_torch.core.subsets import make_subsets
    assert "jax" not in sys.modules and "repro" not in sys.modules

    d = sys.argv[1]
    x = np.random.default_rng(0).normal(size=(200, 16)).astype(np.float32)
    cat = SegmentedCatalog(x, make_subsets(16, 4, 4, seed=0), block=64,
                           persist_dir=d, sync="batch", device="cpu")
    print("READY", flush=True)
    i = 0
    while True:                      # parent SIGKILLs us mid-loop
        rng = np.random.default_rng(100 + i)
        cat.append(rng.normal(size=(10, 16)).astype(np.float32))
        cat.delete([int(rng.integers(0, 200))])
        i += 1
        print("ROUND", i, flush=True)
""")


@pytest.mark.parametrize("grace_s", [0.05, 0.4])
def test_sigkill_mid_ingest_recovers_consistent_prefix(grace_s):
    """A child process running only the port appends/deletes in a loop
    and is SIGKILLed; the port recovers a consistent prefix (clean, or
    typed-torn with salvage) that still serves, and the reference opens
    the directory the port recovered to the same state."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen([sys.executable, "-c", _CHILD, d],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, env=env, cwd=ROOT)
        try:
            line = proc.stdout.readline()
            assert b"READY" in line, proc.stderr.read().decode()
            time.sleep(grace_s)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
        try:
            re = PORT.open(d)
            rep = re.recovery
        except terrors.RecoveryError as e:
            assert e.report.torn_tail
            assert e.catalog is not None
            re, rep = e.catalog, e.report
        snap = re.snapshot()
        k, rem = divmod(snap.n - 200, 10)
        assert rem == 0 and k >= 0       # appends are all-or-nothing
        assert rep.replayed_appends == k
        assert rep.replayed_deletes <= k
        assert rep.last_lsn == k + rep.replayed_deletes
        re.close()
        # the reference reads the directory the port recovered: the same
        # state, clean
        jre = REF.open(d)
        assert jre.recovery.clean
        _same_catalogs(jre, re)
        jre.close()
        re = PORT.open(d)
        re.append(_data(5, seed=99))
        assert re.snapshot().n == 200 + 10 * k + 5
        re.close()
        re2 = PORT.open(d)
        assert re2.recovery.clean
        assert re2.snapshot().n == 200 + 10 * k + 5
        re2.close()


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

def test_checkpoint_on_memory_only_catalog_is_typed_error():
    for P in PKGS:
        eng = P.engine(_data(), live=True)
        with pytest.raises(P.errors.PersistenceError, match="persist_dir"):
            eng.checkpoint()


# ----------------------------------------------------------------------
# cross-package recovery
# ----------------------------------------------------------------------

# crash specs of the matrix above, as (site, action, call, fraction)
CRASHES = [("wal_commit", "crash", 1, 0.5), ("wal_commit", "crash", 4, 0.5),
           ("wal_write", "torn", 2, 0.3), ("wal_write", "torn", 6, 0.9),
           ("wal_write", "torn", 3, 0.0)]
COMPACT_CRASHES = [("segment_write", 2), ("manifest_commit", 2)]


def _crashed_dir(P, d, spec, compact_spec=None):
    """Run MUTATIONS (and a checkpoint after the third) in package P
    under one crash spec, leaving the dead catalog's directory in d."""
    if compact_spec is None:
        site, action, call, frac = spec
        inj = P.inj(site, action, at_calls=(call,), fraction=frac)
    else:
        inj = P.inj(compact_spec[0], "crash", at_calls=(compact_spec[1],))
    cat = P.fresh(_data(), persist_dir=d, faults=inj)
    try:
        _apply(cat, MUTATIONS[:3])
        if compact_spec is None:
            cat.checkpoint()
        _apply(cat, MUTATIONS[3:])
        cat.compact()
    except BaseException as e:       # the injected crash
        assert isinstance(e, P.errors.InjectedCrash), e
    else:
        raise AssertionError("the crash spec never fired")
    del cat


def _open_either(P, d):
    """(catalog, report) of a recovery that may have found damage."""
    try:
        cat = P.open(d)
        return cat, cat.recovery
    except P.errors.RecoveryError as e:
        assert e.catalog is not None
        return e.catalog, e.report


def _cross_open(writer, reader, spec=None, compact_spec=None):
    """A directory ``writer`` crashed in, recovered by both packages from
    two copies: the same state, report and quarantined files, and the
    recovered engines answer a batch with the same ranked results."""
    pos, neg = list(range(8)), list(range(100, 140))
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "n_models": 3,
             "max_results": mr} for m in ("dbranch", "dbens")
            for mr in (20, None)]
    with tempfile.TemporaryDirectory() as root:
        src = os.path.join(root, "src")
        _crashed_dir(writer, src, spec, compact_spec)
        got = {}
        for P in (writer, reader):
            d = os.path.join(root, P.name)
            shutil.copytree(src, d)
            cat, rep = _open_either(P, d)
            cat.close()
            files = sorted(p.relative_to(d).as_posix()
                           for p in Path(d).rglob("*") if p.name != "LOCK")
            eng = P.engine(live=True, data_dir=d)
            assert _report(eng.recovery) == {
                **_report(rep), "orphans_removed": [], "quarantined": [],
                "errors": [], "torn_tail": False}
            outs = eng.query_batch(reqs)
            eng.close()
            got[P.name] = (cat, rep, files, outs)
    a, b = got[writer.name], got[reader.name]
    _same_catalogs(a[0], b[0])
    assert _report(a[1]) == _report(b[1])
    assert a[2] == b[2]
    for ra, rb in zip(a[3], b[3]):
        _same_results(ra, rb)
    return a[1]


@pytest.mark.parametrize("spec", CRASHES,
                         ids=[f"{s}-{c}-{f}" for s, _, c, f in CRASHES])
def test_reference_crash_dir_recovers_in_the_port(spec):
    rep = _cross_open(REF, PORT, spec)
    assert rep.clean == (spec[1] == "crash" or spec[3] == 0.0)


@pytest.mark.parametrize("spec", CRASHES,
                         ids=[f"{s}-{c}-{f}" for s, _, c, f in CRASHES])
def test_port_crash_dir_recovers_in_the_reference(spec):
    rep = _cross_open(PORT, REF, spec)
    assert rep.clean == (spec[1] == "crash" or spec[3] == 0.0)


@pytest.mark.parametrize("compact_spec", COMPACT_CRASHES,
                         ids=[s for s, _ in COMPACT_CRASHES])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_compaction_crash_dir_recovers_in_the_other(writer, compact_spec):
    w, r = (REF, PORT) if writer == "repro" else (PORT, REF)
    assert _cross_open(w, r, compact_spec=compact_spec).clean


def test_same_script_writes_the_same_bytes():
    """MUTATIONS with a checkpoint, a compaction and more mutations
    through both packages: every file of the two directories (WAL,
    manifests, validity overlays, segment column files, meta.json) is
    byte for byte the same; only the LOCK file's pid may differ."""
    blobs = {}
    for P in PKGS:
        with tempfile.TemporaryDirectory() as d:
            cat = P.fresh(_data(), persist_dir=d)
            _apply(cat, MUTATIONS[:3])
            cat.checkpoint()
            _apply(cat, MUTATIONS[3:])
            cat.compact()
            cat.append(_data(9, seed=8))
            cat.delete([1, 2])
            cat.close()
            blobs[P.name] = {p.relative_to(d).as_posix(): p.read_bytes()
                             for p in Path(d).rglob("*")
                             if p.is_file() and p.name != "LOCK"}
    a, b = blobs["repro"], blobs["repro_torch"]
    assert sorted(a) == sorted(b)
    assert any(k.startswith("wal-") for k in a)
    assert any(k.endswith("features.npy") for k in a)
    for k in a:
        assert a[k] == b[k], k


def test_engine_seams_fire_as_in_the_reference():
    """The engine's own seams: ``fused_query`` once per launch round and
    ``device_sync`` before each batched stat sync, counted alike in both
    packages over a static and a live batch in the sparse and dense
    modes; the catalog's ``append`` / ``delete`` / ``compact`` alike; a
    ``fail`` at fused_query raises the retryable error."""
    x = _data(600)
    pos, neg = list(range(8)), list(range(100, 140))
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "n_models": 3,
             "max_results": 20} for m in ("dbranch", "dbens")]
    counts = {}
    for P in PKGS:
        for live in (False, True):
            for mode in ("sparse", "dense"):
                inj = P.faults.FaultInjector()
                eng = P.engine(x[:400], live=live, score_mode=mode,
                               faults=inj)
                eng.query_batch(reqs)
                eng.query(pos, neg, max_results=None)
                if live:
                    eng.append(x[400:])
                    eng.delete([3, 4])
                    eng.delete([3])              # no-op: no record
                    eng.compact()
                    eng.query_batch(reqs)
                counts[P.name, live, mode] = {
                    s: inj.calls(s) for s in P.faults.SITES}
        inj = P.inj("fused_query", "fail", at_calls=(1,))
        eng = P.engine(x, faults=inj)
        with pytest.raises(P.errors.TransientDeviceError):
            eng.query(pos, neg, max_results=10)
        assert eng.query(pos, neg, max_results=10).n_found > 0
    for live in (False, True):
        for mode in ("sparse", "dense"):
            want = counts["repro", live, mode]
            assert counts["repro_torch", live, mode] == want
            assert want["fused_query"] > 0 and want["device_sync"] > 0
            if live:
                assert (want["append"], want["delete"], want["compact"]) \
                    == (1, 2, 1)


def test_fault_registry_is_the_reference():
    assert tfaults.SITES == jfaults.SITES
    assert tfaults.ACTIONS == jfaults.ACTIONS
    with pytest.raises(ValueError, match="unknown fault site"):
        tfaults.FaultSpec("no_such_site")
    with pytest.raises(ValueError, match="action"):
        tfaults.FaultSpec("append", "explode")
    # the seeded probabilistic draws fire on the same calls
    specs = lambda F: [F.FaultSpec("append", "slow", prob=0.3, delay_s=0)]
    a = jfaults.FaultInjector(seed=5, specs=specs(jfaults))
    b = tfaults.FaultInjector(seed=5, specs=specs(tfaults))
    for _ in range(50):
        a.check("append")
        b.check("append")
    assert [r.call for r in a.fired] == [r.call for r in b.fired]
    assert a.fired


def test_durability_snapshot_and_sync_modes_match_reference():
    """``durability_snapshot`` (None without persist_dir) and the stats
    of each sync mode: the same counters in both packages, the same
    recovered state."""
    for sync in ("always", "batch", "none"):
        got = {}
        for P in PKGS:
            assert P.fresh(_data()).durability_snapshot() is None
            with tempfile.TemporaryDirectory() as d:
                cat = P.fresh(_data(), persist_dir=d, sync=sync)
                _apply(cat, MUTATIONS)
                snap = cat.durability_snapshot()
                snap.pop("wal_sync_s")
                cat.close()
                re = P.open(d)
                re.close()
            got[P.name] = (snap, re)
        assert got["repro"][0] == got["repro_torch"][0]
        assert got["repro"][0]["lsn"] == len(MUTATIONS)
        _same_catalogs(got["repro"][1], got["repro_torch"][1])


def test_durable_background_compaction_checkpoints_on_the_merge_thread():
    """A background compaction of a durable port engine commits its
    checkpoint from the merge thread; the directory then recovers, in
    either package, to the reference's synchronously compacted state."""
    x = _data(400)
    with tempfile.TemporaryDirectory() as d:
        eng = PORT.engine(x[:200], live=True, data_dir=d)
        eng.append(x[200:300])
        eng.delete([5, 250])
        th = eng.compact(background=True)
        th.join(timeout=60)
        assert not th.is_alive()
        st = eng.index_stats()
        assert st["n_segments"] == 1
        assert st["durable"]["checkpoints"] == 2     # genesis + compaction
        eng.close()
        oracle = REF.fresh(x[:200])
        oracle.append(x[200:300])
        oracle.delete([5, 250])
        oracle.compact()
        for P in PKGS:
            re = P.open(d)
            assert re.recovery.clean
            assert re.recovery.replayed_appends == 0
            _same_catalogs(re, oracle)
            re.close()


def test_engine_refusals_and_recovery_without_features():
    with tempfile.TemporaryDirectory() as d:
        for P in PKGS:
            with pytest.raises(ValueError, match="live=True"):
                P.engine(_data(), data_dir=d)
            with pytest.raises(ValueError, match="features is required"):
                P.engine(live=True, data_dir=d)
        eng = PORT.engine(_data(), live=True, data_dir=d, wal_sync="always")
        assert eng.recovery is None
        assert eng.index_stats()["durable"]["sync"] == "always"
        eng.append(_data(10, seed=1))
        eng.close()
        # disk wins over the constructor's features and geometry
        re = PORT.Engine(_data(50, seed=9), live=True, data_dir=d,
                         device="cpu", n_subsets=2, block=128)
        assert re.recovery.clean and re.n == 210
        np.testing.assert_array_equal(re.subsets, PORT.subsets)
        assert re.indexes[0].block == BLOCK
        re.close()
    with pytest.raises(ValueError, match="from_catalog"):
        SearchEngine.from_catalog(PORT.fresh(_data()), data_dir="x")
    # a directory the reference wrote with n_shards=2: the port's catalog
    # recovers it (its shard bookkeeping is the reference's), its engine
    # refuses it as it refuses n_shards > 1
    with tempfile.TemporaryDirectory() as d:
        cat = REF.fresh(_data(), persist_dir=d, n_shards=2)
        _apply(cat, MUTATIONS)
        cat.close()
        re = PORT.open(d)
        assert re.n_shards == 2
        re.close()
        jre = REF.open(d)
        _same_catalogs(jre, re)
        jre.close()
        with pytest.raises(NotImplementedError, match="A11"):
            PORT.engine(live=True, data_dir=d)
        PORT.open(d).close()         # the refusal released the directory


@pytest.mark.gpu
def test_recovered_catalog_on_cuda_matches_cpu():
    """A durable catalog written on the CPU and crashed mid-ingest
    recovers onto the card: the batch (both modes) and the scan / knn
    models bitwise the CPU recovery's, through the card's probe."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_durability.py)")
    from repro_torch.kernels import box_scan, zone_prune
    x = _data(3000)
    pos, neg = list(range(8)), list(range(100, 140))
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "n_models": 5,
             "max_results": mr} for m in ("dbranch", "dbens")
            for mr in (30, None)]
    with tempfile.TemporaryDirectory() as root:
        src = os.path.join(root, "src")
        inj = PORT.inj("wal_commit", "crash", at_calls=(3,))
        eng = PORT.engine(x[:2000], live=True, data_dir=src, faults=inj)
        with pytest.raises(terrors.InjectedCrash):
            for chunk in np.array_split(x[2000:], 4):
                eng.append(chunk)
                eng.delete([eng.n - 7])
        del eng
        engines = {}
        for dev in ("cpu", "cuda"):
            d = os.path.join(root, dev)
            shutil.copytree(src, d)
            engines[dev] = SearchEngine(live=True, data_dir=d, device=dev,
                                        **ENG)
        eg, ec = engines["cuda"], engines["cpu"]
        _same_catalogs(eg._catalog, ec._catalog)
        assert eg.index_stats()["device_bytes"]["total"] == 0   # lazy
        for mode in ("sparse", "dense"):
            for e in (eg, ec):
                e.score_mode = mode
            c0 = (zone_prune.candidates_launches, box_scan.seg_launches)
            for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
                _same_results(a, b)
            torch.cuda.synchronize()
            assert zone_prune.candidates_launches > c0[0]
            assert box_scan.seg_launches > c0[1]
        for m in ("dtree", "rforest", "knn"):
            _same_results(eg.query(pos, neg, model=m),
                          ec.query(pos, neg, model=m))
        for e in (eg, ec):
            e.close()


# ----------------------------------------------------------------------
# engine + serve integration (the serving layer's twins)
# ----------------------------------------------------------------------

def _server_cls(p):
    """The serving module of ``p``'s package."""
    return jserve if p is REF else tserve


def test_engine_recovery_surfaces_degraded_health():
    out = []
    for p in PKGS:
        srvmod = _server_cls(p)
        with tempfile.TemporaryDirectory() as d:
            eng = p.engine(_data(), live=True, data_dir=d)
            eng.append(_data(10, seed=1))
            wal = sorted(f for f in os.listdir(d)
                         if f.startswith("wal-"))[-1]
            eng.close()
            del eng
            path = os.path.join(d, wal)
            with open(path, "r+b") as f:     # tear the tail on disk
                f.truncate(os.path.getsize(path) - 3)
            re = p.engine(live=True, data_dir=d)
            assert re.recovery is not None and not re.recovery.clean
            srv = srvmod.QueryServer(re)
            assert srv.health == "degraded"
            s = srv.summary()
            assert s["recovery"]["torn_tail"] and s["recovery"]["quarantined"]
            assert s["durable"]["sync"] == "batch"
            out.append((srv.health, s["recovery"],
                        {k: v for k, v in s["durable"].items()
                         if not isinstance(v, float)},
                        s["epoch"], s["rows_live"], s["n_segments"]))
            re.close()
    assert out[0] == out[1]


def test_server_checkpoint_ingest_op():
    out = []
    for p in PKGS:
        srvmod = _server_cls(p)
        with tempfile.TemporaryDirectory() as d:
            eng = p.engine(_data(), live=True, data_dir=d)
            srv = srvmod.QueryServer(eng)
            r = srv.handle_ingest(srvmod.IngestRequest(
                0, "append", features=_data(10, seed=1)))
            assert r.ok
            r = srv.handle_ingest(srvmod.IngestRequest(1, "checkpoint"))
            assert r.ok and r.info["op"] == "checkpoint"
            assert r.info["lsn"] == 1 and srv.stats["checkpoints"] == 1
            eng.close()
            re = p.engine(live=True, data_dir=d)
            assert re.recovery.clean
            assert re.recovery.replayed_appends == 0
            srv2 = srvmod.QueryServer(re)
            assert srv2.health == "ok"
            pos, neg = list(range(6)), list(range(100, 140))
            q = srv2.handle(srvmod.QueryRequest(2, pos, neg,
                                                kwargs={"max_results": 20}))
            assert q.ok
            out.append(({k: v for k, v in r.info.items()
                         if not isinstance(v, float)},
                        {k: v for k, v in srv.stats.items()
                         if isinstance(v, int)},
                        q.result.ids.tolist(), q.result.scores.tolist()))
            re.close()
    assert out[0] == out[1]
