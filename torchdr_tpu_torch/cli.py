"""Command-line runner (counterpart of ``torchdr_tpu/cli.py``).

    python -m torchdr_tpu_torch.cli info|run|bench
    torchdr-tpu-torch info|run|bench

One process drives every local card, as the JAX package's runner drives
its chips: ``run`` configures the mesh and executes the user's script,
``info`` reports the devices, ``bench`` runs a benchmark script: by
default the port's headline benchmark, ``python -m
torchdr_tpu_torch.benchmarks.bench`` (never the repository's JAX
``bench.py``), with the arguments that follow it.

``run --virtual-cpu-devices N`` makes a mesh built without devices
(``make_mesh()``) N CPU devices, through ``parallel.mesh``'s
``VIRTUAL_CPU_DEVICES_ENV``, as the JAX runner's ``XLA_FLAGS`` make
``jax.devices()`` N CPU devices; it also sets ``TORCHDR_TPU_FORCE_CPU``.
``run --n-devices N`` exports ``TORCHDR_TPU_N_DEVICES``. Both variables are
set as the JAX runner sets them, and nothing reads either, in either
package.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys

BENCH_MODULE = "torchdr_tpu_torch.benchmarks.bench"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="torchdr-tpu-torch",
        description="PyTorch/CUDA dimensionality reduction runner.",
    )
    sub = parser.add_subparsers(dest="command")

    run_p = sub.add_parser("run", help="Run a script with mesh configuration.")
    run_p.add_argument("script", help="Python script to execute.")
    run_p.add_argument(
        "--n-devices",
        type=int,
        default=None,
        help="Exported as TORCHDR_TPU_N_DEVICES, which nothing reads yet.",
    )
    run_p.add_argument(
        "--virtual-cpu-devices",
        type=int,
        default=None,
        help="Build make_mesh() from N CPU devices (testing without a card).",
    )
    run_p.add_argument("script_args", nargs=argparse.REMAINDER)

    sub.add_parser("info", help="Print torch, CUDA and device information.")

    bench_p = sub.add_parser(
        "bench", help="Run a benchmark script; the arguments it does not know are the script's.")
    bench_p.add_argument(
        "--path",
        default=None,
        help=f"Path to a bench script (default: the module {BENCH_MODULE}).",
    )

    # the arguments that ``bench`` does not know are its script's
    args, bench_args = parser.parse_known_args(argv)
    if bench_args and args.command != "bench":
        parser.error(f"unrecognized arguments: {' '.join(bench_args)}")

    if args.command == "info":
        import torch

        print(f"torch {torch.__version__}")
        print(f"cuda {torch.version.cuda}")
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
        return 0

    if args.command == "bench":
        if args.path is None:
            sys.argv = [BENCH_MODULE] + bench_args
            runpy.run_module(BENCH_MODULE, run_name="__main__", alter_sys=True)
            return 0
        # An explicit path is authoritative: do not fall back silently.
        if os.path.isfile(args.path):
            sys.argv = [args.path] + bench_args
            runpy.run_path(args.path, run_name="__main__")
            return 0
        print(f"{args.path} not found; pass --path", file=sys.stderr)
        return 1

    if args.command == "run":
        if args.virtual_cpu_devices:
            from .parallel.mesh import VIRTUAL_CPU_DEVICES_ENV

            os.environ[VIRTUAL_CPU_DEVICES_ENV] = str(args.virtual_cpu_devices)
            os.environ["TORCHDR_TPU_FORCE_CPU"] = "1"
        if args.n_devices:
            os.environ["TORCHDR_TPU_N_DEVICES"] = str(args.n_devices)
        sys.argv = [args.script] + list(args.script_args)
        runpy.run_path(args.script, run_name="__main__")
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
