"""The benchmark of the PyTorch + CUDA port (``fractalrenderer_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for.  Prints one JSON line, the result, as the last line of its standard
output, and the numbers compared with the plain reference as the last
lines of its standard error.  See README.md.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel build directory, a fixed path inside the checkout
os.environ["FRACTAL_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "fractalrenderer_tpu_torch", "_build")
sys.path.insert(0, ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
