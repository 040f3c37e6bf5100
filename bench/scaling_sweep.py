#!/usr/bin/env python
"""Multi-device scaling sweep: step time vs device count per source mode.

On a four-GPU host this measures the c5-and-beyond scaling curve of the
allgather, ring and halfring modes. On the emulated CPU mesh (--emulate N)
it checks the composition only; its timings are not device numbers.

Usage:
    python bench/scaling_sweep.py                 # real devices, all modes
    python bench/scaling_sweep.py --n 131072 --modes ring halfring
    python bench/scaling_sweep.py --emulate 8 --n 4096 --repeats 2

Writes bench/scaling.json (rows keyed by (mode, n_devices, N)).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--modes", nargs="*",
                    default=["allgather", "ring", "halfring"])
    ap.add_argument("--devices", nargs="*", type=int, default=None,
                    help="device counts to sweep (default: 1,2,4,..,all)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--emulate", type=int, default=0,
                    help="emulate this many CPU devices (composition test)")
    args = ap.parse_args()

    import jax

    if args.emulate:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.emulate)
    jax.config.update("jax_enable_x64", True)

    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax.numpy as jnp

    from oc_nbody_tpu.models.plummer import plummer
    from oc_nbody_tpu.parallel import make_mesh, make_sharded_force

    n_avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8, 16, 32)
                              if d <= n_avail]
    from oc_nbody_tpu.ops.backend import resolve_backend
    backend = resolve_backend("auto")
    state = plummer(args.n, jax.random.PRNGKey(0))
    rows = []
    for d in counts:
        for mode in args.modes:
            sf = make_sharded_force(eps=1.0 / 256, mesh=make_mesh(d),
                                    mode=mode, backend=backend)

            @jax.jit
            def chain(pos, k):
                def body(_, p):
                    return p + 1e-300 * sf.accel(p, state.mass)
                return jax.lax.fori_loop(0, k, body, pos)

            chain(state.pos, 1).block_until_ready()
            t0 = time.perf_counter()
            chain(state.pos, 1).block_until_ready()
            t1 = time.perf_counter()
            chain(state.pos, 1 + args.repeats).block_until_ready()
            t2 = time.perf_counter()
            dt = ((t2 - t1) - (t1 - t0)) / args.repeats
            rate = args.n * args.n / dt
            # emulated rows are a COMPOSITION record (the sharded graph
            # compiles + executes at this d), not a performance claim —
            # tagged so no reader mistakes CPU-emulation wall times for
            # ICI scaling (round-2 Missing #3: the record was never
            # written at all)
            row = {"mode": mode, "n_devices": d, "N": args.n,
                   "ms_per_eval": dt * 1e3, "ints_per_s": rate,
                   "backend": backend, "emulated": bool(args.emulate)}
            rows.append(row)
            print(f"d={d} mode={mode:10s} {dt*1e3:9.2f} ms  "
                  f"{rate:.3e} int/s", flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scaling.json")
    payload = {"device": str(jax.devices()[0]), "rows": rows}
    if os.path.exists(out):
        try:
            with open(out) as f:
                old = json.load(f)
            seen = {(r["mode"], r["n_devices"], r["N"],
                     bool(args.emulate)) for r in rows}
            payload["rows"] = sorted(
                [r for r in old.get("rows", [])
                 if (r["mode"], r["n_devices"], r["N"],
                     r.get("emulated", False)) not in seen] + rows,
                key=lambda r: (r.get("emulated", False), r["N"],
                               r["n_devices"], r["mode"]))
            if not args.emulate:
                payload["device"] = str(jax.devices()[0])
            elif "device" in old:
                payload["device"] = old["device"]
        except (json.JSONDecodeError, KeyError):
            pass
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
