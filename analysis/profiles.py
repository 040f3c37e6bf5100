#!/usr/bin/env python
"""Radial structure profiles from a snapshot: density, velocity dispersion,
anisotropy, cumulative mass, and (for IMF-sampled runs) the stellar mass
function inside/outside the half-mass radius (mass segregation).

Capability parity: SURVEY.md §2.14 "analysis scripts" — the standard
open-cluster structure diagnostics beyond the driver's time-series
(plot_run.py covers evolution; this covers one snapshot's structure).

Usage:
    python analysis/profiles.py out/run/snapshot_00003.npz
    python analysis/profiles.py snap.npz --bins 40 --save profiles.png
"""
import argparse
import sys

import numpy as np


def load_snapshot(path):
    with np.load(path, allow_pickle=False) as f:
        pos = np.asarray(f["particles/pos"], np.float64)
        vel = np.asarray(f["particles/vel"], np.float64)
        mass = np.asarray(f["particles/mass"], np.float64)
        t = float(f["@time"]) if "@time" in f.files else np.nan
        units = {k.split("@", 1)[1]: f[k].item() for k in f.files
                 if k.startswith("units@")}
    return pos, vel, mass, t, units


def density_center(pos, mass, iterations=6, shrink=0.7):
    """Shrinking-sphere centre (same scheme as diagnostics.density_center:
    iteratively recentre on the mass-weighted mean inside a shrinking
    radius — robust against tidal-tail contamination)."""
    center = (pos * mass[:, None]).sum(0) / mass.sum()
    radius = np.linalg.norm(pos - center, axis=1).max()
    for _ in range(iterations):
        radius *= shrink
        d = np.linalg.norm(pos - center, axis=1)
        sel = d < radius
        if sel.sum() < 32:
            break
        w = mass[sel]
        center = (pos[sel] * w[:, None]).sum(0) / w.sum()
    return center


def radial_profiles(pos, vel, mass, bins=30, center=None):
    """Log-spaced radial bins -> dict of profile arrays.

    sigma_r/sigma_t are the mass-weighted radial/tangential velocity
    dispersions about the mean cluster velocity; beta = 1 - sig_t^2 /
    (2 sig_r^2) is the Binney anisotropy parameter.
    """
    if center is None:
        center = density_center(pos, mass)
    vcom = (vel * mass[:, None]).sum(0) / mass.sum()
    x = pos - center
    v = vel - vcom
    r = np.linalg.norm(x, axis=1)
    order = np.argsort(r)
    r_s, m_s = r[order], mass[order]

    # half-mass radius from the cumulative profile
    csum = np.cumsum(m_s)
    r_half = float(np.interp(0.5 * csum[-1], csum, r_s))

    rmin = max(np.quantile(r, 0.003), 1e-8)
    rmax = np.quantile(r, 0.995)
    edges = np.geomspace(rmin, rmax, bins + 1)
    idx = np.digitize(r, edges) - 1

    rhat = x / np.maximum(r[:, None], 1e-300)
    vr = (v * rhat).sum(axis=1)
    vt2 = (v * v).sum(axis=1) - vr * vr
    # cylindrical azimuthal velocity about z through the density centre —
    # nonzero mean when the cluster rotates (ic.rotation / tidal torques)
    R = np.maximum(np.hypot(x[:, 0], x[:, 1]), 1e-300)
    vphi = (x[:, 0] * v[:, 1] - x[:, 1] * v[:, 0]) / R

    out = {"r_mid": np.sqrt(edges[:-1] * edges[1:]), "edges": edges,
           "r_half": r_half, "center": center,
           "rho": np.full(bins, np.nan), "sigma_r": np.full(bins, np.nan),
           "sigma_t": np.full(bins, np.nan), "beta": np.full(bins, np.nan),
           "v_phi": np.full(bins, np.nan),
           "count": np.zeros(bins, int),
           "m_cum": np.interp(np.sqrt(edges[:-1] * edges[1:]), r_s, csum)}
    shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    for b in range(bins):
        sel = idx == b
        n = int(sel.sum())
        out["count"][b] = n
        if n < 2:
            continue
        w = mass[sel]
        wsum = w.sum()
        out["rho"][b] = wsum / shell_vol[b]
        mvr = (w * vr[sel]).sum() / wsum
        out["sigma_r"][b] = np.sqrt((w * (vr[sel] - mvr) ** 2).sum() / wsum)
        out["sigma_t"][b] = np.sqrt((w * vt2[sel]).sum() / wsum)
        out["v_phi"][b] = (w * vphi[sel]).sum() / wsum
        if out["sigma_r"][b] > 0:
            out["beta"][b] = 1.0 - out["sigma_t"][b] ** 2 / (
                2.0 * out["sigma_r"][b] ** 2)
    return out


def core_radius(pos, mass, center=None, k=6, chunk=2048):
    """Casertano & Hut (1985) density-weighted core radius and core density.

    Local density around each particle from its k-th nearest neighbour
    (rho_i = (k-1) m_mean / (4/3 pi r_k^3), the CH85 unbiased form), then
      r_core   = sum_i rho_i |x_i - x_d| / sum_i rho_i
      rho_core = sum_i rho_i^2 / sum_i rho_i
    with x_d the density-weighted centre. The standard core-collapse
    diagnostic: r_core shrinks by orders of magnitude toward collapse
    while r_half barely moves. Distances are chunked (O(chunk x N) memory).

    Returns (r_core, rho_core, center_density_weighted).
    """
    n = pos.shape[0]
    k = min(k, n - 1)
    if center is None:
        center = density_center(pos, mass)
    rk = np.empty(n)
    for i0 in range(0, n, chunk):
        blk = pos[i0:i0 + chunk]
        d2 = ((blk[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        # k-th neighbour excluding self (self distance 0 is column k=0)
        rk[i0:i0 + chunk] = np.sqrt(np.partition(d2, k, axis=1)[:, k])
    rho = (k - 1) * mass.mean() / (4.0 / 3.0 * np.pi * np.maximum(
        rk, 1e-300) ** 3)
    wsum = rho.sum()
    c_d = (rho[:, None] * pos).sum(0) / wsum
    r_core = float((rho * np.linalg.norm(pos - c_d, axis=1)).sum() / wsum)
    rho_core = float((rho * rho).sum() / wsum)
    return r_core, rho_core, c_d


def projected_profiles(pos, vel, mass, bins=30, center=None, axis=2):
    """Observational (projected) profiles along a line of sight.

    Projects out ``axis`` (default z) and returns log-binned surface
    density Σ(R), the mass-weighted line-of-sight velocity dispersion
    σ_LOS(R), and the (2-D) effective radius R_eff enclosing half the
    mass in projection — the quantities star-cluster observations
    actually constrain (cf. the 3-D profiles above)."""
    if center is None:
        center = density_center(pos, mass)
    keep = [i for i in range(3) if i != axis]
    xy = (pos - center)[:, keep]
    vlos = vel[:, axis] - (vel[:, axis] * mass).sum() / mass.sum()
    R = np.linalg.norm(xy, axis=1)
    order = np.argsort(R)
    csum = np.cumsum(mass[order])
    r_eff = float(np.interp(0.5 * csum[-1], csum, R[order]))

    rmin = max(np.quantile(R, 0.003), 1e-8)
    rmax = np.quantile(R, 0.995)
    edges = np.geomspace(rmin, rmax, bins + 1)
    idx = np.digitize(R, edges) - 1
    ring = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
    out = {"R_mid": np.sqrt(edges[:-1] * edges[1:]), "edges": edges,
           "r_eff": r_eff, "Sigma": np.full(bins, np.nan),
           "sigma_los": np.full(bins, np.nan), "count": np.zeros(bins, int)}
    for b in range(bins):
        sel = idx == b
        n = int(sel.sum())
        out["count"][b] = n
        if n < 2:
            continue
        w = mass[sel]
        out["Sigma"][b] = w.sum() / ring[b]
        mv = (w * vlos[sel]).sum() / w.sum()
        out["sigma_los"][b] = np.sqrt(
            (w * (vlos[sel] - mv) ** 2).sum() / w.sum())
    return out


def mst_length(points):
    """Total edge length of the Euclidean minimum spanning tree (dense
    pairwise distances through scipy.sparse.csgraph — the sets here are
    tens of points)."""
    from scipy.sparse.csgraph import minimum_spanning_tree

    pts = np.asarray(points, float)
    if len(pts) < 2:
        return 0.0
    d = np.sqrt(np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1))
    return float(minimum_spanning_tree(d).sum())


def mass_segregation_ratio(pos, mass, n_massive=20, n_sets=50, seed=0):
    """Allison et al. (2009) Λ_MSR: MST length of ``n_sets`` random
    same-size samples over the MST length of the ``n_massive`` most
    massive stars. Λ ≈ 1: no segregation; Λ > 1 (beyond the quoted
     1σ): the massive stars are more centrally concentrated.

    Returns (lambda_msr, sigma) or None for degenerate inputs (fewer
    than 2·n_massive stars, or an equal-mass model where "most massive"
    is meaningless)."""
    n = len(mass)
    if n < 2 * n_massive or mass.max() / mass.min() < 1.001:
        return None
    idx_massive = np.argsort(mass)[-n_massive:]
    l_massive = mst_length(pos[idx_massive])
    if l_massive <= 0:
        return None
    rng = np.random.default_rng(seed)
    lengths = [mst_length(pos[rng.choice(n, n_massive, replace=False)])
               for _ in range(n_sets)]
    return (float(np.mean(lengths) / l_massive),
            float(np.std(lengths) / l_massive))


def king62_sigma(R, k, rc, rt):
    """King (1962) empirical surface-density profile
    Σ(R) = k [ (1+(R/rc)²)^{-1/2} − (1+(rt/rc)²)^{-1/2} ]²  for R < rt,
    0 beyond — the form observers fit to star-cluster photometry."""
    R = np.asarray(R, float)
    t = 1.0 / np.sqrt(1.0 + (rt / rc) ** 2)
    val = 1.0 / np.sqrt(1.0 + (R / rc) ** 2) - t
    return k * np.where(R < rt, val, 0.0) ** 2


def fit_king62(R_mid, Sigma, count, r_eff):
    """Weighted least-squares King62 fit to a binned Σ(R) profile.

    Residuals are relative (model − Σ)/(Σ/√n) — Poisson-ish weighting,
    well-defined beyond the fitted truncation where the model is 0.
    Returns dict(k, rc, rt, c=log10(rt/rc), ok) or None when scipy's
    optimizer or the data are unusable (< 5 populated bins)."""
    from scipy.optimize import least_squares

    sel = (count >= 3) & np.isfinite(Sigma) & (Sigma > 0)
    if sel.sum() < 5:
        return None
    R, S, n = R_mid[sel], Sigma[sel], count[sel]

    # initial guess: rc where Σ falls to half its (inner) maximum, rt a
    # few times the projected half-mass radius
    s0 = S[np.argmin(R)]
    below = R[S < 0.5 * s0]
    rc0 = float(below.min()) if below.size else float(r_eff) / 2
    rt0 = 8.0 * float(r_eff)
    t0 = 1.0 / np.sqrt(1.0 + (rt0 / rc0) ** 2)
    k0 = s0 / (1.0 - t0) ** 2

    # parametrize rt = rc (1 + e^q): rt > rc by construction, so the
    # reported concentration log10(rt/rc) can never come out negative
    def unpack(p):
        k, rc = np.exp(p[:2])
        rt = rc * (1.0 + np.exp(p[2]))
        return k, rc, rt

    def resid(p):
        k, rc, rt = unpack(p)
        return (king62_sigma(R, k, rc, rt) - S) * np.sqrt(n) / S

    q0 = np.log(max(rt0 / rc0 - 1.0, 1e-2))
    try:
        res = least_squares(resid, [np.log(k0), np.log(rc0), q0],
                            bounds=([np.log(s0 * 1e-4),
                                     np.log(R.min() * 1e-2), np.log(1e-2)],
                                    [np.log(s0 * 1e6), np.log(R.max()),
                                     np.log(1e4)]),
                            max_nfev=2000)
    except Exception:
        return None
    k, rc, rt = unpack(res.x)
    return {"k": float(k), "rc": float(rc), "rt": float(rt),
            "c": float(np.log10(rt / rc)), "ok": bool(res.success)}


def mass_function(mass, sel, bins=20):
    """dN/dlog10(m) histogram over a selection (equal-mass runs return
    a single bin — callers should check the dynamic range first)."""
    m = mass[sel]
    lo, hi = m.min(), m.max()
    if hi / lo < 1.001:
        return None
    edges = np.geomspace(lo, hi, bins + 1)
    n, _ = np.histogram(m, bins=edges)
    dlog = np.diff(np.log10(edges))
    return {"m_mid": np.sqrt(edges[:-1] * edges[1:]), "dn_dlogm": n / dlog}


def evolution(run_dir, save=None):
    """Structure evolution over a run's snapshot sequence: r_core (CH85),
    r_half, and rho_core vs time — the core-collapse view (r_core shrinks
    by orders of magnitude toward collapse while r_half barely moves)."""
    import glob
    import os

    snaps = sorted(glob.glob(os.path.join(run_dir, "snapshot_*.npz")))
    if len(snaps) < 2:
        print(f"need >= 2 snapshots in {run_dir}, found {len(snaps)}")
        return 1
    rows = []
    print(f"{'t':>10} {'r_core':>10} {'r_half':>10} {'rho_core':>12}")
    for path in snaps:
        pos, vel, mass, t, _ = load_snapshot(path)
        c = density_center(pos, mass)
        r = np.sort(np.linalg.norm(pos - c, axis=1))
        csum = np.cumsum(mass[np.argsort(np.linalg.norm(pos - c, axis=1))])
        r_half = float(np.interp(0.5 * csum[-1], csum, r))
        r_c, rho_c, _ = core_radius(pos, mass, center=c)
        rows.append((t, r_c, r_half, rho_c))
        print(f"{t:10.4f} {r_c:10.4g} {r_half:10.4g} {rho_c:12.5g}")
    arr = np.asarray(rows)
    out = save or os.path.join(run_dir, "structure_evolution.png")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.6, 4))
    ax1.plot(arr[:, 0], arr[:, 1], lw=2, label="r_core (CH85)")
    ax1.plot(arr[:, 0], arr[:, 2], lw=2, label="r_half")
    ax1.set_yscale("log"), ax1.legend()
    ax1.set_xlabel("t [code]"), ax1.set_ylabel("radius [code]")
    ax2.plot(arr[:, 0], arr[:, 3], lw=2, c="tab:red")
    ax2.set_yscale("log")
    ax2.set_xlabel("t [code]"), ax2.set_ylabel("rho_core [code]")
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot", help="a snapshot file, or (with "
                    "--evolution) a run directory")
    ap.add_argument("--bins", type=int, default=30)
    ap.add_argument("--save", default=None, help="write a profiles PNG")
    ap.add_argument("--evolution", action="store_true",
                    help="treat the argument as a run directory and plot "
                    "r_core/r_half/rho_core vs time over all snapshots")
    ap.add_argument("--projected", action="store_true",
                    help="also print projected (observational) profiles: "
                    "surface density, sigma_LOS, R_eff")
    ap.add_argument("--king-fit", action="store_true",
                    help="fit the King (1962) empirical profile to the "
                    "projected surface density; prints rc, rt and the "
                    "concentration c = log10(rt/rc) (implies --projected)")
    args = ap.parse_args(argv)
    if args.king_fit:
        args.projected = True

    if args.evolution:
        return evolution(args.snapshot, save=args.save)

    pos, vel, mass, t, units = load_snapshot(args.snapshot)
    p = radial_profiles(pos, vel, mass, bins=args.bins)
    r = np.linalg.norm(pos - p["center"], axis=1)

    r_c, rho_c, _ = core_radius(pos, mass, center=p["center"])
    print(f"t={t:.6g}  N={len(mass)}  r_half={p['r_half']:.4g}  "
          f"r_core={r_c:.4g}  rho_core={rho_c:.4g} (Casertano-Hut)")
    print(f"{'r_mid':>10} {'rho':>12} {'sigma_r':>10} {'sigma_t':>10} "
          f"{'beta':>8} {'v_phi':>10} {'M(<r)':>10} {'n':>6}")
    for b in range(args.bins):
        if p["count"][b] == 0:
            continue
        print(f"{p['r_mid'][b]:10.4g} {p['rho'][b]:12.5g} "
              f"{p['sigma_r'][b]:10.4g} {p['sigma_t'][b]:10.4g} "
              f"{p['beta'][b]:8.3f} {p['v_phi'][b]:10.4g} "
              f"{p['m_cum'][b]:10.5g} {p['count'][b]:6d}")

    ok = p["count"] > 1
    sig = np.nanmean(p["sigma_r"][ok])
    vrot = np.nansum(p["v_phi"][ok] * p["count"][ok]) / p["count"][ok].sum()
    if sig > 0 and abs(vrot) > 0.1 * sig:
        print(f"rotation: <v_phi>/sigma_r = {vrot / sig:+.3f} "
              f"(ordered rotation about z)")

    if args.projected:
        pp = projected_profiles(pos, vel, mass, bins=args.bins,
                                center=p["center"])
        print(f"projected: R_eff = {pp['r_eff']:.4g} "
              f"(r_half = {p['r_half']:.4g}; R_eff/r_half "
              f"= {pp['r_eff'] / p['r_half']:.3f}, ~0.74 for Plummer)")
        print(f"{'R_mid':>10} {'Sigma':>12} {'sigma_LOS':>10} {'n':>6}")
        for b in range(args.bins):
            if pp["count"][b] == 0:
                continue
            print(f"{pp['R_mid'][b]:10.4g} {pp['Sigma'][b]:12.5g} "
                  f"{pp['sigma_los'][b]:10.4g} {pp['count'][b]:6d}")
        if args.king_fit:
            kf = fit_king62(pp["R_mid"], pp["Sigma"], pp["count"],
                            pp["r_eff"])
            if kf is None:
                print("king fit: not enough populated bins")
            else:
                print(f"king fit: rc = {kf['rc']:.4g}  rt = {kf['rt']:.4g} "
                      f" c = log10(rt/rc) = {kf['c']:.3f} "
                      f"{'(converged)' if kf['ok'] else '(NOT converged)'}")

    mf_in = mass_function(mass, r < p["r_half"])
    mf_out = mass_function(mass, r >= p["r_half"])
    if mf_in is not None:
        mean_in = mass[r < p["r_half"]].mean()
        mean_out = mass[r >= p["r_half"]].mean()
        print(f"mass function: <m> inside r_half = {mean_in:.4g}, outside "
              f"= {mean_out:.4g} (ratio {mean_in / mean_out:.3f} — >1 "
              f"indicates mass segregation)")
        msr = mass_segregation_ratio(pos - p["center"], mass)
        if msr is not None:
            lam, sig = msr
            verdict = ("segregated" if lam - 2 * sig > 1
                       else "inverse-segregated" if lam + 2 * sig < 1
                       else "consistent with none")
            print(f"mass segregation: Lambda_MSR(20) = {lam:.3f} "
                  f"± {sig:.3f} (Allison+ 2009 MST ratio — {verdict})")

    if args.save:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        npanels = 3 + (mf_in is not None)
        fig, axes = plt.subplots(1, npanels, figsize=(4.2 * npanels, 3.6))
        ok = p["count"] > 1
        axes[0].loglog(p["r_mid"][ok], p["rho"][ok], "o-", ms=3)
        axes[0].axvline(p["r_half"], ls=":", c="gray")
        axes[0].set_xlabel("r")
        axes[0].set_ylabel(r"$\rho(r)$")
        axes[1].semilogx(p["r_mid"][ok], p["sigma_r"][ok], "o-", ms=3,
                         label=r"$\sigma_r$")
        axes[1].semilogx(p["r_mid"][ok], p["sigma_t"][ok] / np.sqrt(2),
                         "s-", ms=3, label=r"$\sigma_t/\sqrt{2}$")
        if np.nanmax(np.abs(p["v_phi"][ok])) > 0.1 * np.nanmean(
                p["sigma_r"][ok]):
            axes[1].semilogx(p["r_mid"][ok], p["v_phi"][ok], "^-", ms=3,
                             label=r"$\langle v_\phi\rangle$")
        axes[1].set_xlabel("r")
        axes[1].legend()
        axes[2].semilogx(p["r_mid"][ok], p["m_cum"][ok], "o-", ms=3)
        axes[2].set_xlabel("r")
        axes[2].set_ylabel("M(<r)")
        if mf_in is not None:
            axes[3].loglog(mf_in["m_mid"], mf_in["dn_dlogm"], "o-", ms=3,
                           label="r < r_half")
            axes[3].loglog(mf_out["m_mid"], mf_out["dn_dlogm"], "s-", ms=3,
                           label="r > r_half")
            axes[3].set_xlabel("m")
            axes[3].set_ylabel(r"$dN/d\log m$")
            axes[3].legend()
        fig.suptitle(f"t = {t:.4g}")
        fig.tight_layout()
        fig.savefig(args.save, dpi=130, bbox_inches="tight")
        print(f"wrote {args.save}")


if __name__ == "__main__":
    sys.exit(main())
