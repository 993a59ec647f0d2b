"""Shared guard for offline-fixture generation, a copy of
``fedml_tpu/data/fixture_util.py``. The marker names and contents are the
JAX package's, so either package recognises the other's fixtures.

Every BASELINE-repro fixture writer follows the same contract:

- archives the generator did not write (no marker) are REAL data and are
  never touched;
- a fixture whose marker records the same config is reused;
- a config mismatch regenerates (stale files + marker deleted first);
- the marker is written BEFORE data files land so a crash can never leave
  archives that read as real data;
- markers are DATASET-KEYED (``.fedml_tpu_offline_fixture.<dataset>``) so
  two datasets' fixtures sharing one directory cannot invalidate — or worse,
  delete — each other's files. The round-2 un-keyed marker name is honored
  as a legacy fixture indicator.
"""

from __future__ import annotations

import json
from pathlib import Path

# legacy (round-2) marker: one un-keyed file per directory
LEGACY_MARKER = ".fedml_tpu_offline_fixture"


def marker_path(out_dir: str | Path, dataset: str) -> Path:
    return Path(out_dir) / f"{LEGACY_MARKER}.{dataset}"


def is_fixture(out_dir: str | Path, dataset: str) -> bool:
    """True when this dataset's files in ``out_dir`` are a generated fixture
    (keyed marker, or the legacy un-keyed marker from older rounds)."""
    out = Path(out_dir)
    return marker_path(out, dataset).exists() or (out / LEGACY_MARKER).exists()


def prepare(out_dir: str | Path, dataset: str, config: dict,
            files: list[str]) -> bool:
    """Decide whether generation should proceed for ``files`` (the fixture's
    data files, first entry = the primary existence probe).

    Returns False when generation must be skipped: the primary file exists
    and is either real data (no marker — never deleted) or a current fixture
    (marker config matches). Otherwise deletes any stale fixture files and
    writes the config-bearing marker, then returns True — the caller
    generates into tmp files and renames them into place.
    """
    out = Path(out_dir)
    marker = marker_path(out, dataset)
    legacy = out / LEGACY_MARKER
    config_line = json.dumps(config, sort_keys=True)
    primary = out / files[0]
    if marker.exists() and not primary.exists():
        # stale KEYED marker from a crashed generation (the probe never
        # landed). Honoring it would classify REAL archives placed here
        # later as a fixture — and a subsequent config change would then
        # delete the user's data. Drop the marker and the partial fixture
        # files it proves we wrote — but ONLY files at least as new as the
        # marker (the marker lands before any data file): an older file
        # cannot be the crashed generation's output, and a real archive a
        # user placed here after the crash is newer but gets a loud log
        # line naming exactly what was removed. The un-keyed LEGACY marker
        # is deliberately left alone here: it cannot be attributed to a
        # dataset, and it may be vouching for ANOTHER dataset's fixture
        # files in this shared directory.
        import logging

        marker_mtime = marker.stat().st_mtime
        for name in files:
            p = out / name
            if p.exists() and p.stat().st_mtime >= marker_mtime:
                logging.warning(
                    "fixture_util: removing %s — written after the stale "
                    "%s fixture marker (crashed generation)", p, dataset,
                )
                p.unlink()
        marker.unlink(missing_ok=True)
    if primary.exists():
        if not marker.exists() and not legacy.exists():
            return False  # real archives — leave them alone
        if marker.exists():
            lines = marker.read_text().splitlines()
            if lines and lines[-1] == config_line:
                return False  # current fixture
        # stale fixture (config mismatch, or legacy un-keyed marker):
        # regenerate for this config
        for name in files:
            (out / name).unlink(missing_ok=True)
        marker.unlink(missing_ok=True)
        legacy.unlink(missing_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    marker.write_text(
        f"generated by fedml_tpu — offline fixture for {dataset}; "
        "NOT real data\n" + config_line + "\n"
    )
    return True
