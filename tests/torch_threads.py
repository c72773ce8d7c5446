"""The CPU test run's thread budget for torch.

The tier-1 command runs the suite in several pytest-xdist workers at
once, and torch sizes its intra-op pool to every core in each of them:
six workers' pools on an eight-core host oversubscribe it, and its
threads spin while they wait. Six copies of one training test ran
1.8x longer at the default pool than at two threads each. Importing
this module caps the importing process's pool at ``CPU_THREADS``: the
port's test modules import it, so collection caps every worker. The
processes a test starts are not affected (the tests that start torch
workers give them their own ``OMP_NUM_THREADS``).
"""

import torch

CPU_THREADS = 2

if torch.get_num_threads() > CPU_THREADS:
    torch.set_num_threads(CPU_THREADS)
