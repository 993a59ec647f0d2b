"""How many ops one FedNAS search step dispatches at the DARTS search width,
and how long a first- and a second-order step take.

    python3 -m fedml_tpu_torch.fednas_ops [--device cpu|cuda] [--batch B]

It builds the DARTS search network at the search width (16 channels, 8
cells, 4 steps, 10 classes, 32x32 images; ``--batch`` images a batch,
default 2), counts the ops one first-order ``search_step`` sends to the
backend (under a ``TorchDispatchMode``; views and other metadata ops, which
launch no kernel, are counted apart), then runs a first-order and a
second-order step twice each and times the second call (host clock, after a
synchronisation on the card; on the CPU with 4 threads). It prints one JSON
object. A CPU run's times are the CPU's, not the card's: they say how the
host's share of a step grows from the first order to the second.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fedml_tpu_torch.algorithms.fednas import FedNASTrainer
from fedml_tpu_torch.core.trainer import adam, sgd
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.models.darts import DARTSNetwork

# ops that only make or change a tensor's metadata: no kernel
_METADATA = ("view", "unsqueeze", "permute", "unbind", "select", "slice", "alias", "expand",
             "detach", "as_strided", "t.default", "squeeze", "promote_types", "_unsafe_view",
             "transpose")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("fedml_tpu_torch.fednas_ops")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=2)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(4)
    net = DARTSNetwork(num_classes=10, channels=16, layers=8, steps=4, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    batch = {"x": torch.rand(args.batch, 32, 32, 3, generator=g, device=device),
             "y": torch.randint(0, 10, (args.batch,), generator=g, device=device),
             "mask": torch.ones(args.batch, device=device)}
    out = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "batch": args.batch}
    for unrolled in (False, True):
        tr = FedNASTrainer(net, sgd(0.025), adam(3e-4), unrolled=unrolled, unrolled_eta=0.025)
        variables = tr.init(torch.Generator(device=device).manual_seed(0))
        params, arch, _ = tr.split(variables)
        opt = (tr.w_opt.init(params), tr.arch_opt.init(arch))

        def step():
            tr.search_step(variables, opt, batch, batch)
            if device.type == "cuda":
                torch.cuda.synchronize()

        name = "second_order" if unrolled else "first_order"
        if not unrolled:
            counter = _Counter()
            with counter:
                step()
            meta = sum(n for op, n in counter.ops.items() if any(m in op for m in _METADATA))
            out["first_order_ops"] = sum(counter.ops.values())
            out["first_order_metadata_ops"] = meta
        step()
        t0 = time.perf_counter()
        step()
        out[f"{name}_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
