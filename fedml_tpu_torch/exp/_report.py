"""Marked-section report writer, a copy of ``update_section``,
``ceiling_lookup`` and ``acc_curve`` from ``fedml_tpu/exp/_report.py``: each
reproduction runner owns one section of its report file and regenerates it
without touching the others."""

from __future__ import annotations

from pathlib import Path


def update_section(path: str | Path, name: str, content: str) -> None:
    """Replace (or append) the section delimited by HTML comment markers."""
    begin = f"<!-- BEGIN {name} -->"
    end = f"<!-- END {name} -->"
    block = f"{begin}\n{content.strip()}\n{end}\n"
    p = Path(path)
    text = p.read_text() if p.exists() else ""
    if begin in text and end in text:
        head = text[: text.index(begin)]
        tail = text[text.index(end) + len(end):].lstrip("\n")
        text = head + block + ("\n" + tail if tail else "")
    else:
        text = (text.rstrip() + "\n\n" if text.strip() else "") + block
    p.write_text(text)


def ceiling_lookup(label: str, report_path: str | Path | None = None,
                   store: str | Path = "repro_ceilings.json"):
    """Row from the fixture-ceilings sidecar store (repro_ceilings.py), or
    None. Lets each repro section emit its own ceiling cross-reference so
    regeneration never wipes it. The store is looked up next to the report
    being written first, then relative to the cwd."""
    import json

    candidates = [Path(store)]
    if report_path is not None:
        candidates.insert(0, Path(report_path).resolve().parent / Path(store).name)
    p = next((c for c in candidates if c.exists()), None)
    if p is None:
        return None
    try:
        data = json.loads(p.read_text())
    except json.JSONDecodeError:
        return None
    row = data.get(label) if isinstance(data, dict) else None
    return row if isinstance(row, dict) else None


def acc_curve(evals: list, points: int = 12, key: str = "Test/Acc") -> str:
    """Downsampled ``round:acc%`` curve string for report sections."""
    step = max(1, len(evals) // points)
    return ", ".join(
        f"{e['round']}:{e[key] * 100:.1f}" for e in evals[::step]
    )
