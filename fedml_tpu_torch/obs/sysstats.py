"""System metrics, the port of ``fedml_tpu/obs/sysstats.py`` (reference:
fedml_api/distributed/fedavg_cross_silo/SysStats.py:13): the host sample
``MLOpsLogger.report_system_metric`` sends (cpu and memory from psutil when
present, else the process's resident size from /proc) and the device-memory
gauges of the fleet telemetry plane: live and peak bytes from
``torch.cuda.memory_stats`` where the JAX package reads
``Device.memory_stats()``, and the card's total, under the JAX package's
key names.
"""

from __future__ import annotations

import time
from typing import Any

import torch

try:
    import psutil

    HAS_PSUTIL = True
except Exception:  # pragma: no cover
    HAS_PSUTIL = False


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
    """Samples host and device utilization. The constructor primes
    psutil's cpu counter, so the first :meth:`sample` reports utilization
    since construction instead of a constant 0.0."""

    def __init__(self):
        self._t0 = time.time()
        if HAS_PSUTIL:
            psutil.cpu_percent(interval=None)  # prime the delta counter

    def sample(self) -> dict[str, Any]:
        out: dict[str, Any] = {"uptime_s": time.time() - self._t0}
        if HAS_PSUTIL:
            vm = psutil.virtual_memory()
            p = psutil.Process()
            out.update(
                cpu_utilization=psutil.cpu_percent(interval=None),
                system_memory_utilization=vm.percent,
                process_memory_in_use=p.memory_info().rss,
                process_memory_available=vm.available,
                process_cpu_threads_in_use=p.num_threads(),
            )
        else:  # /proc fallback
            try:
                with open("/proc/self/status") as fh:
                    for line in fh:
                        if line.startswith("VmRSS"):
                            out["process_memory_in_use"] = int(line.split()[1]) * 1024
            except OSError:
                pass
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            ms = _device_memory_stats(i)
            if ms:
                out[f"device{i}_bytes_in_use"] = ms.get("bytes_in_use")
                out[f"device{i}_bytes_limit"] = ms.get("bytes_limit")
                if ms.get("peak_bytes_in_use") is not None:
                    out[f"device{i}_peak_bytes_in_use"] = ms["peak_bytes_in_use"]
        return out

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
