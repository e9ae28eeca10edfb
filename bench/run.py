"""One run of one benchmark cell of the PyTorch/CUDA port:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, last on
standard output, and the numbers its output check compared, each beside
its limit, last on standard error.  Exits 2 without a result where the
card or the cards the cell needs are missing, 3 where the run loaded JAX
or the JAX package.  Every build and kernel cache stays inside the
checkout, under ``build/``, the compiled bytecode of the modules it
imports too."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# compiled bytecode of every module imported from here on, torch's
# included, written into the checkout even where the environment says not
# to write any (PYTHONDONTWRITEBYTECODE): a later run reads it instead of
# compiling every source again, which is most of a run's set-up where the
# installation holds no bytecode
sys.pycache_prefix = str(ROOT / "build" / "bench" / "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0, root=ROOT))
