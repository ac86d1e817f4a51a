"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Exits non-zero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), when the run fails, and when JAX or the JAX package
is loaded once the window has closed. The last lines on standard error are
the numbers that decided ``correct``, each beside its limit; the last line
on standard output is the result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache of the run stays inside the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: "
              f"{', '.join(cells)}", file=sys.stderr)
        return 2

    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3

    from benchmark.harness import execute, forbidden_modules

    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), started=STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded in the run: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
