"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The program's kernels build into ``build/fasta_tpu_torch/`` of the
checkout on the first run; every other cache goes under ``build/portbench/``.
The last line of standard output is the result's JSON; the set-up's
pieces, the route, the card and each number compared beside its limit go
to standard error.
"""

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    CACHE = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    import torch  # noqa: F401  (a caller of a PyTorch library has it loaded)
    sys.path[0] = str(ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT))
