"""The port's benchmark: see `harness.py` and the repository's `PERF.md`.

Importing the package points every cache the port or PyTorch may build
(Triton, Inductor, extensions, the CUDA JIT) at a fixed path under
`build/perfbench/` in the checkout, and puts the checkout's `src/`, where
the port lives, on the import path."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "perfbench" / _sub)
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))
