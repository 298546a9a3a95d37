"""QPO-frequency driver — the port's `grtrace.cli.qpo`: the three
epicyclic frequencies of circular equatorial geodesics against radius.

    python -m grtrace_torch.cli.qpo --spin 0.9 --preset grs1915 --no-plots
    python -m grtrace_torch.cli.qpo --metric hayward --metric-param 0.5 \\
        --preset grs1915 --device cpu
    python -m grtrace_torch.cli.qpo --metric kerr-ds --spin 0.8 \\
        --metric-param 1e-4 --mass-msun 10 --no-plots

Sweeps the orbital (nu_phi), radial epicyclic (nu_r) and vertical
epicyclic (nu_theta) frequencies from the ISCO outward, with the
periastron (nu_phi - nu_r) and nodal (nu_phi - nu_theta) precession
frequencies, for the Kerr-Newman family (physics/epicyclic.py), a static
beyond-Kerr family (physics/static_orbits.py), a rotating regular family
(physics/rotating_orbits.py) or Kerr-de Sitter (physics/kerr_de_sitter.py,
whose sweep stops at the outermost stable circular orbit).  Every
derivative is autodiff (torch.func / torch.autograd), as JAX's are.
Writes qpo_frequencies.csv (and qpo_frequencies.png unless --no-plots)
and prints one JSON line of metrics: the ISCO, the frequencies there, the
maximum of nu_r and the 3:2 resonance radius; `main` returns them.

The sweep runs on --device (the CUDA card by default, exiting with a
message when there is none; --device cpu for the CPU), in float64; the
ISCO and OSCO scans and bisections run on the host, as the theory layer
does everywhere in the port.  No kernel runs: the sweep is a few hundred
scalar orbits.  JAX's --platform is --device here.
"""
from __future__ import annotations

import argparse
import json
import math
import os

# stellar-mass QPO sources join the imaging presets (masses: McClintock et
# al. 2006 for GRS 1915+105; Orosz et al. 2011 for Cyg X-1)
QPO_PRESETS = {
    "grs1915": 12.4,
    "cygx1": 14.8,
    "sgra": 4.297e6,
    "m87": 6.5e9,
}
STATIC_NAMES = {"kottler": "Kottler", "sds": "Kottler",
                "bardeen": "Bardeen", "hayward": "Hayward"}
ROTATING_NAMES = {"rotating-bardeen": "RotatingBardeen",
                  "rotating-hayward": "RotatingHayward"}


def build_parser():
    p = argparse.ArgumentParser(
        description="epicyclic / QPO frequencies of circular orbits")
    p.add_argument('--mass', type=float, default=1.0,
                   help='geometrized mass M (code units)')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--metric', type=str, default='kerr',
                   choices=('kerr', 'kottler', 'sds', 'bardeen', 'hayward',
                            'rotating-bardeen', 'rotating-hayward',
                            'kerr-ds'),
                   help='spacetime family: kerr (spin/charge), a static '
                        'beyond-Kerr family, a rotating regular family or '
                        'Kerr-de Sitter (--spin + --metric-param)')
    p.add_argument('--metric-param', type=float, default=0.0,
                   help='family parameter: Lambda (kottler, kerr-ds), '
                        'magnetic charge g (bardeen), core length l '
                        '(hayward)')
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--mass-msun', type=float, default=None,
                   help='physical mass in solar masses (for Hz axes)')
    p.add_argument('--preset', type=str, default=None,
                   choices=sorted(QPO_PRESETS))
    p.add_argument('--r-max', type=float, default=20.0,
                   help='outer sweep radius in units of M')
    p.add_argument('--n', type=int, default=256, help='radial samples')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run the sweep on the CUDA card (the default; exits '
                        'with a message when there is none) or on the CPU')
    p.add_argument('--no-plots', '--no-plot', dest='no_plots',
                   action='store_true',
                   help='skip qpo_frequencies.png (it needs matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def _vmapped(fn, r):
    """(Omega_phi, kappa, Omega_theta) of fn(r_i) for every element of the
    1-D tensor r (fn takes a 0-dim radius)."""
    import torch
    from torch.func import vmap
    out = vmap(lambda rr: torch.stack(fn(rr)))(r)
    return out[:, 0], out[:, 1], out[:, 2]


def sweep(args, device):
    """(r (n,) float64 on `device`, r_isco, (Omega_phi, kappa,
    Omega_theta)) in code units, JAX's branches: the ISCO (and Kerr-de
    Sitter's OSCO) on the host in float64, the frequencies on `device`."""
    import numpy as np
    import torch

    prograde = not args.retrograde
    f64 = torch.float64

    def linspace(lo, hi):
        return torch.linspace(lo, hi, args.n, dtype=f64, device=device)

    if args.metric == 'kerr-ds':
        from ..physics.kerr_de_sitter import epicyclic_kds, isco_kds, osco_kds
        host = torch.tensor([args.mass, args.spin, args.metric_param],
                            dtype=f64)
        r_isco = float(isco_kds(host, prograde))
        if not np.isfinite(r_isco):
            raise SystemExit(
                f"kerr-ds at (a, Lambda) = ({args.spin:g}, "
                f"{args.metric_param:g}) has no stable circular orbits "
                "— no QPO band")
        r_top = args.r_max * args.mass
        r_osco = float(osco_kds(host, prograde))
        if np.isfinite(r_osco):
            r_top = min(r_top, r_osco)
        r = linspace(r_isco, r_top)
        params = host.to(device)
        return r, r_isco, _vmapped(
            lambda rr: epicyclic_kds(rr, params, prograde), r)
    if args.metric in ROTATING_NAMES:
        from ..physics.rotating_orbits import (epicyclic_rotating,
                                               isco_rotating)
        from ..physics.rotating_regular import MASS_FN
        m_fn = MASS_FN[ROTATING_NAMES[args.metric]]
        host = torch.tensor([args.mass, args.spin, args.metric_param],
                            dtype=f64)
        r_isco = float(isco_rotating(host, m_fn, prograde))
        if not np.isfinite(r_isco):
            raise SystemExit(
                f"{args.metric} at (a, p) = ({args.spin:g}, "
                f"{args.metric_param:g}) has no stable circular orbits "
                "— no QPO band")
        r = linspace(r_isco, args.r_max * args.mass)
        params = host.to(device)
        return r, r_isco, _vmapped(
            lambda rr: epicyclic_rotating(rr, params, m_fn, prograde), r)
    if args.metric in STATIC_NAMES:
        from ..physics.static_metrics import STATIC_F
        from ..physics.static_orbits import epicyclic_static, isco_static
        f_fn = STATIC_F[STATIC_NAMES[args.metric]]
        host = torch.tensor([args.mass, args.metric_param, 0.0], dtype=f64)
        r_isco = float(isco_static(f_fn, host))
        if not np.isfinite(r_isco):
            raise SystemExit(
                f"{args.metric} with parameter {args.metric_param:g} has "
                "no stable circular orbits — no QPO band")
        r = linspace(r_isco, args.r_max * args.mass)
        params = host.to(device)
        # spherical symmetry: retrograde orbits mirror the prograde ones
        return r, r_isco, _vmapped(
            lambda rr: epicyclic_static(rr, f_fn, params), r)
    from ..physics.epicyclic import epicyclic_frequencies, isco_from_kappa
    host = torch.tensor([args.mass, args.spin, args.charge], dtype=f64)
    r_isco = float(isco_from_kappa(host, prograde))
    r = linspace(r_isco, args.r_max * args.mass)
    # elementwise in r: the sweep is one batched autograd pass
    return r, r_isco, epicyclic_frequencies(r, host.to(device), prograde)


def _plot(args, r_np, nu, cols, unit, r_isco, prograde, png_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for c, style in zip(cols, ["-", "-", "-", "--", "--"]):
        ax.plot(r_np / args.mass, nu[c], style, label=c.replace("_", " "))
    ax.axvline(r_isco / args.mass, color="gray", lw=0.8, ls=":",
               label=f"ISCO {r_isco / args.mass:.3f} M")
    ax.set_xlabel("r / M")
    ax.set_ylabel(f"frequency [{unit}]")
    ax.set_yscale("log")
    sense = "prograde" if prograde else "retrograde"
    if args.metric in STATIC_NAMES:
        ax.set_title(f"epicyclic frequencies  {STATIC_NAMES[args.metric]} "
                     f"param={args.metric_param:g} ({sense})")
    elif args.metric in ROTATING_NAMES:
        ax.set_title(f"epicyclic frequencies  "
                     f"{ROTATING_NAMES[args.metric]} a={args.spin} "
                     f"param={args.metric_param:g} ({sense})")
    else:
        ax.set_title(f"epicyclic frequencies  a={args.spin} "
                     f"Q={args.charge} ({sense})")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(png_path, dpi=120)
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .line_grid import check_device
    check_device(args.device, "qpo")
    from ..viz import plots
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.qpo: the figure needs "
                         "matplotlib, which this Python does not have; pass "
                         "--no-plots")
    if args.metric == 'kerr' and \
            args.spin ** 2 + args.charge ** 2 > args.mass ** 2:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    mass_msun = (QPO_PRESETS[args.preset] if args.preset
                 else args.mass_msun)

    import numpy as np

    from ..physics.epicyclic import T_SUN_S

    prograde = not args.retrograde
    r, r_isco, (om_phi, kappa, om_th) = sweep(args, args.device)

    # code units -> Hz (nu = Omega M_code / (2 pi M_phys); identity scale
    # when no physical mass is given, columns then in c^3/GM)
    scale = (args.mass / (2.0 * math.pi * mass_msun * T_SUN_S)
             if mass_msun else args.mass / (2.0 * math.pi))
    unit = "Hz" if mass_msun else "c^3/(2 pi G M)"
    r_np = r.cpu().numpy()
    nu = {k: v.detach().cpu().numpy() * scale for k, v in
          [("nu_phi", om_phi), ("nu_r", kappa), ("nu_theta", om_th)]}
    nu["nu_periastron"] = nu["nu_phi"] - nu["nu_r"]
    nu["nu_nodal"] = nu["nu_phi"] - nu["nu_theta"]

    os.makedirs(args.out_dir, exist_ok=True)
    csv_path = os.path.join(args.out_dir, "qpo_frequencies.csv")
    cols = ["nu_phi", "nu_r", "nu_theta", "nu_periastron", "nu_nodal"]
    header = "r_over_M," + ",".join(f"{c}_{unit.split()[0]}" for c in cols)
    np.savetxt(csv_path, np.column_stack(
        [r_np / args.mass] + [nu[c] for c in cols]),
        delimiter=",", header=header, comments="")
    png_path = os.path.join(args.out_dir, "qpo_frequencies.png")
    if not args.no_plots:
        _plot(args, r_np, nu, cols, unit, r_isco, prograde, png_path)

    i_max = int(np.argmax(nu["nu_r"]))

    # 3:2 epicyclic resonance radius (twin-peak HF QPOs): the last crossing
    # of nu_theta / nu_r = 3/2 (h = 2 nu_theta - 3 nu_r from + to -),
    # linearly interpolated on the sweep grid
    h = 2.0 * nu["nu_theta"] - 3.0 * nu["nu_r"]
    r32 = nu32_hi = nu32_lo = None
    cross = np.nonzero((h[:-1] > 0) & (h[1:] <= 0))[0]
    if cross.size:
        i = int(cross[-1])
        w = h[i] / (h[i] - h[i + 1])
        r32 = float((1 - w) * r_np[i] + w * r_np[i + 1]) / args.mass
        nu32_hi = float((1 - w) * nu["nu_theta"][i]
                        + w * nu["nu_theta"][i + 1])
        nu32_lo = nu32_hi * 2.0 / 3.0

    metrics = {
        "r_32_resonance_over_M": r32,
        "nu_32_upper": nu32_hi, "nu_32_lower": nu32_lo,
        "r_isco_over_M": r_isco / args.mass,
        "nu_phi_isco": float(nu["nu_phi"][0]),
        "nu_r_max": float(nu["nu_r"][i_max]),
        "r_nu_r_max_over_M": float(r_np[i_max] / args.mass),
        "unit": unit,
        "metric": args.metric, "metric_param": args.metric_param,
        "spin": args.spin, "charge": args.charge, "prograde": prograde,
        "mass_msun": mass_msun,
        "csv": csv_path, "png": None if args.no_plots else png_path,
    }
    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
