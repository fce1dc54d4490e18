"""The benchmark of ``kmergma_tpu_torch`` on NVIDIA H100s.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with the reference beside its limit; the
same checks are the last lines of standard error.  Exits non-zero with no
result line where CUDA is missing or has fewer devices than the cell
asks for, where the program is not in the checkout, and where JAX or the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: JAX, its libraries, and the
#: JAX package, compared by whole top-level name (the port's name starts
#: with the JAX package's)
FORBIDDEN = {"jax", "jaxlib", "flax", "kmergma_tpu"}


def _fail(msg: str, code: int) -> "None":
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & FORBIDDEN)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        _fail("--seed must be a non-negative whole number", 2)

    # the program's build caches stay in the checkout, at fixed paths
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    if not (ROOT / "kmergma_tpu_torch" / "__init__.py").is_file():
        _fail(f"the program kmergma_tpu_torch is not in {ROOT}", 4)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.runner import run_cell
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        _fail("CUDA is not available", 2)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} CUDA devices, {torch.cuda.device_count()} present", 2)
    work = Path(tempfile.mkdtemp(prefix="kmergma-bench-"))
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        _fail(f"loaded after the window: {', '.join(found)}", 3)
    print(f"card: {_card()}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
