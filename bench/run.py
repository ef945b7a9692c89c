"""Run one cell of the port's benchmark.

    python3 bench/run.py --workload W --seed N --seconds S --trace 0|1

from the root of a checkout.  It puts ``src`` on the path itself, draws
the weights and the traffic from ``--seed`` on the card, warms every
shape the cell's traffic uses (set-up), measures for ``--seconds``,
checks what was served against the plain fp32 reference, and prints one
JSON line last on standard output; the numbers compared, each with its
limit, are the last lines of standard error.  ``--trace 1`` also traces a
bounded stretch of calls after the window and reports the per-layer
metrics instead of the end-to-end ones.

It exits with 1 and prints no result where there is no CUDA card (or
fewer than the cell asks for), no program beside it, or an unknown cell,
and where a module of JAX or of the JAX package was loaded.
``--control fp8`` (not used by the benchmark's own runs) judges the
lower-precision control in the program's place on the same sample: such
a run has to come out not correct.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench.harness import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)
    env.set_cache_dirs()
    try:
        env.add_program_path()
        from bench.harness import spec
        cell = spec.load_cell(args.workload)
        import torch
        if not torch.cuda.is_available():
            raise env.SetupError("no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise env.SetupError(f"{args.workload} needs {cell.chips} "
                                 f"cards, {torch.cuda.device_count()} here")
        torch.set_num_threads(2)
        from bench.harness.run_cell import emit, run
        emit(*run(args.workload, args.seed, args.seconds, bool(args.trace),
                  device="cuda", control=args.control, t_start=T_START))
    except env.SetupError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    except RuntimeError:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
