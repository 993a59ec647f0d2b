"""Device-memory gauges for the fleet telemetry plane, the port of
``fedml_tpu/obs/sysstats.py``'s ``SysStats.publish_device_gauges`` (the one
part of it the wire runner calls; reference:
fedml_api/distributed/fedavg_cross_silo/SysStats.py:13): live and peak
bytes from ``torch.cuda.memory_stats`` where the JAX package reads
``Device.memory_stats()``, and the card's total, under the JAX package's
gauge names.
"""

from __future__ import annotations

import torch


def _device_memory_stats(index: int) -> dict | None:
    """Live, peak and total bytes of CUDA device ``index`` in the JAX
    package's key names, or None (telemetry never raises)."""
    try:
        ms = torch.cuda.memory_stats(index)
        return {"bytes_in_use": ms.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": ms.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(index).total_memory}
    except Exception:
        return None


class SysStats:
    def publish_device_gauges(self) -> dict[str, int]:
        """Live and peak bytes and the card's total per CUDA device,
        published into the installed :mod:`fedml_tpu_torch.obs.registry`
        (skipped when none is installed). Without a card a silent no-op.
        Returns the gauges it published."""
        from fedml_tpu_torch.obs import registry

        reg = registry.get()
        out: dict[str, int] = {}
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            ms = _device_memory_stats(i)
            if not ms:
                continue
            for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                v = ms.get(key)
                if v is None:
                    continue
                name = f"device{i}/{key}"
                out[name] = int(v)
                if reg is not None:
                    reg.gauge(name, int(v))
        return out
