"""Re-run the op-trace estimator over stored dry-run traces — counterpart
of ``repro.launch.reanalyze``.

``python -m repro_torch.launch.reanalyze [--art-dir DIR]`` updates every
dry-run JSON in place from its ``.trace.json.gz`` sibling (the files
``launch/dryrun.py`` and ``launch/search_dryrun.py`` write), so an
estimator change never needs the cells traced again. The memory figures
are the trace's own and stay as they are.
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys
from pathlib import Path
from typing import Optional

from repro_torch.launch.dryrun import ART_DIR, TRACE_SUFFIX, summarize
from repro_torch.launch.hlo_analysis import analyze


def reanalyze(art_dir: Optional[Path] = None) -> tuple:
    """(updated, skipped): every ok JSON under ``art_dir`` with a trace
    beside it re-priced by ``analyze``."""
    art_dir = Path(art_dir or ART_DIR)
    updated = skipped = 0
    for jpath in sorted(art_dir.glob("*.json")):
        d = json.loads(jpath.read_text())
        gz = art_dir / (jpath.stem + TRACE_SUFFIX)
        if not d.get("ok") or not gz.exists():
            skipped += 1
            continue
        with gzip.open(gz, "rt") as f:
            deep = analyze(json.load(f))
        d.update(summarize(deep))
        jpath.write_text(json.dumps(d, indent=1))
        updated += 1
        print(f"[reanalyzed] {jpath.name}")
    return updated, skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art-dir", default=None,
                    help=f"the dry runs' files (default {ART_DIR})")
    updated, skipped = reanalyze(ap.parse_args(argv).art_dir)
    print(f"updated={updated} skipped(no trace)={skipped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
