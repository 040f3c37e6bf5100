"""CLI entry point: ``python -m oc_nbody_tpu run configs/plummer_1k.toml``.

Capability parity: SURVEY.md §2.13 — driver/CLI with dot-overrides
(``--set integrator.eta=0.01``) and resume-from-checkpoint.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="oc_nbody_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run a simulation from a config file")
    p_run.add_argument("config", help="TOML or JSON config path")
    p_run.add_argument("--set", dest="overrides", action="append", default=[],
                       metavar="a.b=v", help="override a config value")
    p_run.add_argument("--resume", action="store_true",
                       help="resume from the latest snapshot in out_dir")
    p_run.add_argument("--profile", metavar="DIR", default=None,
                       help="capture a Perfetto/XProf trace of the run "
                            "into DIR (view with xprof/tensorboard)")
    p_run.add_argument("--platform", default=None,
                       choices=("cpu", "gpu"),
                       help="force the JAX platform (default: JAX's own "
                            "choice, the GPU where there is one). cpu uses "
                            "the jnp blocked kernels — useful for debugging "
                            "on a machine without a GPU")

    p_ens = sub.add_parser(
        "ensemble",
        help="run MANY realizations of one config in a single vmapped "
             "program (survey mode: one chip integrates the whole batch)")
    p_ens.add_argument("config")
    p_ens.add_argument("--set", dest="overrides", action="append",
                       default=[], metavar="a.b=v")
    p_ens.add_argument("--seeds", required=True,
                       help="ic.seed values: 'a:b' (half-open range) or a "
                            "comma list, e.g. 0:64 or 3,17,42")
    p_ens.add_argument("--out", default=None,
                       help="output .npz path (default out_dir/ensemble.npz)")
    p_ens.add_argument("--sweep", default=None, metavar="a.b=v1,v2,...",
                       help="add a state-side parameter axis (ic.* or "
                            "orbit.*): runs the cartesian product "
                            "seeds x values, e.g. orbit.R0_pc=3000,4500,6000")
    p_ens.add_argument("--platform", default=None, choices=("cpu", "gpu"))

    p_info = sub.add_parser("info", help="print a resolved config")
    p_info.add_argument("config")
    p_info.add_argument("--set", dest="overrides", action="append", default=[])

    args = parser.parse_args(argv)

    if getattr(args, "platform", None):
        # must land before the first backend touch
        import jax
        jax.config.update("jax_platforms", args.platform)

    from oc_nbody_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from oc_nbody_tpu.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(args.config), args.overrides)

    if args.command == "info":
        print(cfg.to_json())
        return 0

    if args.command == "ensemble":
        if ":" in args.seeds:
            a, b = args.seeds.split(":")
            seeds = list(range(int(a), int(b)))
        else:
            seeds = [int(s) for s in args.seeds.split(",") if s]

        sweep = None
        if args.sweep:
            key, vals = args.sweep.split("=", 1)
            sweep = {key: [float(v) for v in vals.split(",") if v]}

        from oc_nbody_tpu.ensemble import run_ensemble

        def progress(i, n, row):
            import numpy as _np
            e = _np.asarray(row["E_tot"], _np.float64)
            print(f"interval {i}/{n}  <E>={e.mean():+.6e}  "
                  f"members={e.size}", flush=True)

        res = run_ensemble(cfg, seeds, out_path=args.out, sweep=sweep,
                           progress=progress if cfg.output.stdout else None)
        print(f"done: {len(res.seeds)} members x {res.n_steps} steps "
              f"wall={res.wall_time_s:.1f}s out={res.out_path}")
        return 0

    from oc_nbody_tpu.run import run

    result = run(cfg, resume=args.resume, profile_dir=args.profile)
    print(f"done: t={float(result.state.time):.6g} steps={result.n_steps} "
          f"wall={result.wall_time_s:.1f}s out={result.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
