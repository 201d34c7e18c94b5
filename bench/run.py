"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window under ``torch.profiler``).
Without a card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result; so it does where ``src/repro_torch`` is
missing, and where JAX or the JAX package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TORCH_THREADS = 4


def environment() -> None:
    """Every cache of the program and of its libraries at a fixed path
    inside the checkout (ignored by git), so that only a cell's first run
    in a checkout builds; JAX kept out of libraries that would load it."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    os.environ["USE_FLAX"] = "0"
    # the repository root (for ``bench``) and ``src`` (for the port), and
    # not ``bench/`` itself, whose folder names are no top-level modules
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]


def fail(message: str, code: int = 2) -> int:
    print(f"bench/run.py: {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return fail(f"the program is missing: no src/repro_torch under "
                    f"{ROOT}")
    import torch

    from bench.harness.spec import Spec

    spec = Spec.load()
    if args.workload not in spec.workloads:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    chips = int(spec.workloads[args.workload]["chips"])
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()}")
    torch.set_num_threads(TORCH_THREADS)

    from bench.harness.cell import forbidden_modules, run_cell

    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, spec=spec)
    bad = forbidden_modules()
    if bad:
        return fail("JAX or the JAX package is loaded: " + ", ".join(bad),
                    3)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
