"""One torch intra-op thread per test process.

The tier-1 suite runs in several pytest-xdist workers at once on one host,
and torch's CPU operators default to one OpenMP thread per core in each of
them: six workers then run six times the host's cores in threads, whose
idle spinning slowed the port's eleven slowest test files from 113 s to
417 s (six workers, ``--dist loadfile``, an 8-core host). Every
``tests/test_torch_*.py`` module imports this one; xdist's workers import
every test module when they collect, so the setting holds in every worker
before its first test. Results do not depend on it beyond the last bits of
a multi-threaded reduction, which no test reads.
"""

import torch

torch.set_num_threads(1)


def test_one_torch_thread_per_worker():
    assert torch.get_num_threads() == 1
