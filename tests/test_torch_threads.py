"""One bound on torch's CPU threads for every test of the PyTorch port.

Every ``tests/test_torch_*.py`` imports this module first.  The tier-1
command runs six pytest workers on one machine, each beside JAX's own
threads; torch's default intra-op pool (a thread a CPU in every worker)
then spends most of a port test's time waiting on the other workers'
threads.

The bound, one thread, is set in this process (``torch.set_num_threads``;
the inter-op pool where torch still allows it) and, through
``OMP_NUM_THREADS``, in every process the tests start: the CLI
subprocesses, the gloo ranks and the preprocessing workers read it when
their torch starts.
"""

import os
import subprocess
import sys

THREADS = 1

os.environ["OMP_NUM_THREADS"] = str(THREADS)

import torch  # noqa: E402

torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:
    pass    # parallel work has begun in this process: the pool stays


def test_this_process_runs_torch_on_the_bound():
    assert torch.get_num_threads() == THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(THREADS)


def test_a_started_process_inherits_the_bound():
    code = "import torch; print(torch.get_num_threads())"
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    assert int(out) == THREADS
