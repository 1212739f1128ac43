"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of
Distributed-GAN.  From the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run loads, warms up, measures for ``--seconds`` (``--trace 1``:
then profiles one more call) and checks its output against the plain
reference; it prints the numbers compared beside their limits
as the last lines of standard error and one JSON object as the last line
of standard output.  It exits non-zero, printing no result, without the
CUDA devices the cell needs, or when JAX or the JAX package has been
imported.  Caches (the kernels' nvcc builds, ``torch.utils.cpp_extension``
and Triton's) live under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"          # one process, few threads: steadier
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from bench import harness

    result, lines = harness.execute(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"refusing to report: these modules were imported: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
