"""Marked-section report writer, a copy of ``update_section`` and
``acc_curve`` from ``fedml_tpu/exp/_report.py``: each reproduction runner
owns one section of its report file and regenerates it without touching the
others."""

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


def acc_curve(evals: list, points: int = 12, key: str = "Test/Acc") -> str:
    """Downsampled ``round:acc%`` curve string for report sections."""
    step = max(1, len(evals) // points)
    return ", ".join(
        f"{e['round']}:{e[key] * 100:.1f}" for e in evals[::step]
    )
