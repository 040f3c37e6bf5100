#!/usr/bin/env python
"""Round-5 VERDICT W3: attribute the pruned-1M dE_cons = 6.2e-4.

bench/prune_scale.json recorded max |dE_cons_over_E_int| = 6.2e-4 for
the pruned c10p 32-step segment, ~20x looser than the 16k
full-dissolution run's 2.9e-5 — unremarked. Candidate causes, each
isolated by one controlled segment of the SAME config
(configs/c10p_1m_macro_prune.toml):

  ctl     — escape.prune = false: the unpruned control's plain
            |dE_over_E_int| over the same 32 steps. If this is already
            ~5e-4 class, the number is the 1M f32 measurement floor of
            THIS deeply super-tidal config (phi summation noise scales
            ~sqrt(N); E_int is small against the 4 kpc tide), not a
            pruning cost.
  pruned  — the committed config (control for comparability at HEAD).
  diag2   — repartition cadence halved (diag_every doubled): each
            boundary's ledger entry is measured with f32 phi, so if the
            residual is boundary-accounting noise it shrinks with fewer
            boundaries; if it is reduced-Hamiltonian truncation it
            doesn't.

Writes bench/prune_conservation.json.
"""
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "ctl": {"escape.prune": "false"},
    "pruned": {},
    "diag2": {"output.diag_every": "0.0625"},
}


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    from oc_nbody_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np
    from oc_nbody_tpu.config import apply_overrides, load_config
    from oc_nbody_tpu.run import run

    summary = {}
    path = "bench/prune_conservation.json"
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    for name, ov in VARIANTS.items():
        out_dir = f"out/prune_cons_{name}"
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        ov = dict(ov)
        ov.update({"output.out_dir": out_dir, "output.stdout": "false",
                   "output.snap_every": "1000.0"})
        cfg = apply_overrides(
            load_config("configs/c10p_1m_macro_prune.toml"),
            [f"{k}={v}" for k, v in ov.items()])
        print(f"--- variant {name} ---", flush=True)
        res = run(cfg)
        col = ("dE_cons_over_E_int" if "dE_cons_over_E_int"
               in res.diagnostics else "dE_over_E_int")
        d = np.asarray(res.diagnostics[col])
        summary[name] = {
            "column": col,
            "max_abs": float(np.abs(d).max()),
            "series": [float(x) for x in d],
            "n_steps": int(res.n_steps),
            "wall_s": float(res.wall_time_s),
        }
        print(name, json.dumps(summary[name]), flush=True)

    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
