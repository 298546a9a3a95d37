"""CLI flags of `python -m grtrace_torch.cli.main` — every flag of
`grtrace.cli.args` by the same name and with the same default.

As in the JAX package, the reference's effective behaviour is the default
and fixes are opt-in: --omega is parsed but only forwarded with
--fix-omega (the reference's integrator always ran omega 1.0); --cuda,
--rtol, --atol and --suppress-warnings are accepted for compatibility;
--order 4/6/8 are real Yoshida-composed steps.  The port's own flags:
--backend takes 'auto' | 'cuda' | 'torch' (and the JAX names 'pallas' /
'xla', which map to 'cuda' / 'torch'); --device picks the card ('cuda',
the default) or the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                        SceneConfig, apply_relative_offsets)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Black Hole Ray Tracing Simulation (PyTorch / CUDA)")
    p.add_argument('--size', type=int, default=200, help='Image size (NxN)')
    p.add_argument('--fov', type=float, default=80.0,
                   help='Field of view in degrees')
    p.add_argument('--background', type=str,
                   default='images/backgrounds/milky-way-equirec.jpg',
                   help='Background image path')
    p.add_argument('--steps', type=int, default=200000,
                   help='Number of integration steps for each geodesic')
    p.add_argument('--delta', type=float, default=0.01,
                   help='Integration step size')
    p.add_argument('--omega', type=float, default=0.01,
                   help='Hamiltonian flow coupling omega (see --fix-omega)')
    p.add_argument('--fix-omega', action='store_true',
                   help='Actually forward --omega to the integrator (the '
                        'reference silently used omega=1.0)')
    p.add_argument('--rtol', type=float, default=1e-2,
                   help='Accepted for compatibility (unused, like reference)')
    p.add_argument('--atol', type=float, default=1e-2,
                   help='Accepted for compatibility (unused, like reference)')
    p.add_argument('--order', type=int, default=2, choices=[2, 4, 6, 8],
                   help='Symplectic integration order (all four implemented '
                        'here; the reference only ever ran order 2)')
    p.add_argument('--suppress-warnings', action='store_true',
                   help='Suppress numerical warnings during integration')
    p.add_argument('--cuda', action='store_true', default=True,
                   help='Compatibility no-op (see --backend)')
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'],
                   help='Integrator backend: auto = the CUDA kernels on the '
                        'card, the eager torch twins on the CPU; cuda '
                        'demands the kernels, torch the twins (pallas and '
                        'xla are their JAX names)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='Run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--bh-mass', type=float, default=1.0,
                   help='Black hole mass')
    p.add_argument('--metric', type=str, default='schwarzschild',
                   choices=['schwarzschild', 'kerr', 'kerr-bl',
                            'kottler', 'bardeen', 'hayward',
                            'rotating-bardeen', 'rotating-hayward',
                            'kerr-ds'],
                   help='Spacetime metric (beyond the reference, which is '
                        'Schwarzschild-only).  kerr = horizon-penetrating '
                        'Kerr-Schild chart (best numerics); kerr-bl = '
                        'Boyer-Lindquist (physics cross-check engine); '
                        'kottler = Schwarzschild-de Sitter, bardeen/'
                        'hayward = regular (singularity-free) holes — '
                        'static families whose parameter is --metric-param;'
                        ' rotating-bardeen/rotating-hayward = spinning '
                        'regular holes (Kerr-Schild mass-function chart, '
                        '--spin + --metric-param)')
    p.add_argument('--metric-param', type=float, default=0.0,
                   help='Family parameter of the beyond-Kerr metrics: '
                        'cosmological constant Lambda (kottler, units '
                        '1/M^2), magnetic charge g (bardeen / '
                        'rotating-bardeen), core length l (hayward / '
                        'rotating-hayward).  0 = Schwarzschild/Kerr limit')
    p.add_argument('--spin', type=float, default=0.0,
                   help='Kerr spin a in [0, M] (requires --metric kerr)')
    p.add_argument('--charge', type=float, default=0.0,
                   help='Electric charge Q with a^2 + Q^2 <= M^2 '
                        '(Kerr-Newman; Q with spin 0 = Reissner-Nordstrom; '
                        'works with any --metric, always rendered by the '
                        'generic engine)')
    p.add_argument('--boundary-radius', type=float, default=31,
                   help='Simulation boundary radius')
    p.add_argument('--observer-distance', type=float, default=30,
                   help='Observer distance from BH')
    p.add_argument('--bg-patch-center-theta', type=float, default=90,
                   help='Background patch center theta (deg)')
    p.add_argument('--bg-patch-center-phi', type=float, default=180,
                   help='Background patch center phi (deg)')
    p.add_argument('--bg-patch-center-theta-relobs', type=float, default=0,
                   help='Patch center theta offset rel. optical axis (deg)')
    p.add_argument('--bg-patch-center-phi-relobs', type=float, default=0,
                   help='Patch center phi offset rel. optical axis (deg)')
    p.add_argument('--bg-patch-size-theta', type=float, default=180,
                   help='Background patch size theta (deg)')
    p.add_argument('--bg-patch-size-phi', type=float, default=360,
                   help='Background patch size phi (deg)')
    p.add_argument('--bg-flip-theta', action='store_true',
                   help='Flip theta mapping for background patch')
    p.add_argument('--bg-flip-phi', action='store_true',
                   help='Flip phi mapping for background patch')
    p.add_argument('--no-flat-trajectories', action='store_true',
                   default=False,
                   help='Disable flat (no-gravity) trajectory rendering')
    p.add_argument('--n-samples', type=int, default=20,
                   help='Number of sampled diagnostic trajectories')
    p.add_argument('--aa', type=int, default=0, metavar='S',
                   help='Adaptive shadow-edge antialiasing: re-trace SxS '
                        'stratified sub-rays for the boundary pixels only '
                        'and average their colors (engine/aa.py; class '
                        'map and CSVs keep center-sample semantics)')
    # --- accretion disk mode (beyond the reference; engine/disk.py) ---
    p.add_argument('--disk', action='store_true',
                   help='Render a thin equatorial accretion disk (GR '
                        'redshift/Doppler shading; engine.disk, kernel B6)')
    p.add_argument('--disk-r-in', type=float, default=None,
                   help='Disk inner edge (default: the prograde ISCO)')
    p.add_argument('--disk-r-out', type=float, default=14.0,
                   help='Disk outer edge')
    p.add_argument('--disk-elevation', type=float, default=12.0,
                   help='Camera elevation above the disk plane (deg); '
                        '0 = the standard equatorial observer (edge-on)')
    p.add_argument('--disk-temp', type=float, default=9000.0,
                   help='Peak disk color temperature (K)')
    p.add_argument('--disk-exposure', type=float, default=2.5,
                   help='Disk tone-mapping gain')
    p.add_argument('--disk-profile', choices=('shakura', 'novikov'),
                   default='shakura',
                   help='Radial temperature law: shakura = Newtonian '
                        'Shakura-Sunyaev, novikov = relativistic '
                        'Novikov-Thorne (Page-Thorne flux quadrature)')
    p.add_argument('--disk-emissivity', type=float, default=3.0,
                   help='Emissivity power-law index q (I_em ~ r^-q) for '
                        'the line-profile artifact')
    p.add_argument('--disk-bfield', choices=('vertical', 'toroidal',
                                             'radial'), default=None,
                   help='Polarized imaging: magnetic-field geometry for '
                        'Walker-Penrose EVPA maps (physics.polarization)')
    p.add_argument('--disk-retrograde', action='store_true',
                   help='Disk counter-rotates with the hole')
    p.add_argument('--camera-omega', type=str, default=None,
                   metavar='W|keplerian|zamo',
                   help='Put the camera on a circular worldline with this '
                        'coordinate angular velocity (exact GR aberration '
                        '+ Doppler via the orthonormal camera tetrad); '
                        "'keplerian' = the circular-geodesic rate at the "
                        "camera radius, 'zamo' = the locally nonrotating "
                        'observer')
    p.add_argument('--save-transfer', type=str, default=None, metavar='NPZ',
                   help='Persist the geodesic transfer map (per-pixel '
                        'crossing invariants) so the disk can be re-shaded '
                        'without retracing (io.transfer; see '
                        'python -m grtrace_torch.cli.reshade)')
    p.add_argument('--out-dir', type=str, default='.',
                   help='Output directory for artifacts')
    p.add_argument('--no-plots', action='store_true',
                   help='Skip matplotlib scene diagnostics')
    p.add_argument('--seed', type=int, default=0,
                   help='Sampling seed (reference used unseeded random)')
    p.add_argument('--profile', action='store_true',
                   help='Write a torch.profiler Chrome trace to '
                        '<out-dir>/torch_trace/trace.json')
    p.add_argument('--print-metrics', action='store_true',
                   help='Print per-stage timings and throughput as JSON')
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def disk_from_args(args):
    """argparse Namespace -> DiskConfig, or None when --disk is absent."""
    if not getattr(args, 'disk', False):
        return None
    from ..engine.disk import DiskConfig
    cam = getattr(args, 'camera_omega', None)
    if cam is not None and cam not in ('keplerian', 'zamo'):
        try:
            cam = float(cam)
        except ValueError:
            raise SystemExit(f"--camera-omega must be a number, "
                             f"'keplerian' or 'zamo', got {cam!r}")
    return DiskConfig(r_in=args.disk_r_in, r_out=args.disk_r_out,
                      prograde=not args.disk_retrograde,
                      t_peak=args.disk_temp, exposure=args.disk_exposure,
                      elevation_deg=args.disk_elevation,
                      profile=args.disk_profile,
                      emissivity_index=args.disk_emissivity,
                      bfield=args.disk_bfield,
                      camera_omega=cam)


def scene_from_args(args) -> SceneConfig:
    """argparse Namespace -> SceneConfig (applies the relative patch offsets
    exactly like reference main.py:34-40)."""
    patch_theta, patch_phi = apply_relative_offsets(
        args.bg_patch_center_theta, args.bg_patch_center_phi,
        args.bg_patch_center_theta_relobs, args.bg_patch_center_phi_relobs)
    omega = args.omega if args.fix_omega else 1.0
    static_metrics = ('kottler', 'bardeen', 'hayward')
    rotating_regular = ('rotating-bardeen', 'rotating-hayward')
    if args.spin and args.metric not in ('kerr', 'kerr-bl', 'kerr-ds') + \
            rotating_regular:
        raise SystemExit("--spin requires --metric kerr, kerr-bl, "
                         "kerr-ds, or a rotating regular family")
    if args.metric == 'kerr-ds':
        if args.charge:
            raise SystemExit(
                "--charge applies to the Kerr-Newman family only; "
                "kerr-ds takes --metric-param (Lambda)")
        if args.metric_param < 0:
            raise SystemExit("--metric-param (Lambda) must be >= 0")
        if not abs(args.spin) < args.bh_mass:
            raise SystemExit("kerr-ds needs |a| < M")
        if args.metric_param > 0:
            # same freeze constraint as Kottler: the static coordinates
            # explode at the cosmological horizon; the vacuum bound
            # sqrt(3/Lambda) overestimates r_c by up to ~M, demand margin
            if args.boundary_radius >= 0.9 * np.sqrt(
                    3.0 / args.metric_param):
                raise SystemExit(
                    "kerr-ds: the escape boundary must sit well inside "
                    "the cosmological horizon — need boundary_radius < "
                    "0.9 sqrt(3/Lambda)")
    elif args.metric in rotating_regular:
        if args.charge:
            raise SystemExit(
                "--charge applies to the Kerr-Newman family only; the "
                "rotating regular families take --metric-param")
        if args.metric_param < 0:
            raise SystemExit("--metric-param must be >= 0")
        if not abs(args.spin) < args.bh_mass:
            raise SystemExit("rotating regular families need |a| < M")
        # horizonless super-critical points are allowed (the regular core
        # replaces the shadow) — no existence validation here; the render
        # falls back to the capture floor (physics/rotating_regular.py)
    elif args.metric in static_metrics:
        if args.charge:
            raise SystemExit(
                "--charge applies to the Kerr-Newman family only; the "
                "static families take --metric-param")
        if args.metric_param < 0:
            raise SystemExit("--metric-param must be >= 0")
        if args.metric == 'kottler' and \
                args.metric_param * args.bh_mass ** 2 >= 1.0 / 9.0:
            raise SystemExit(
                "Kottler needs Lambda M^2 < 1/9 (beyond that the black-"
                "hole and cosmological horizons merge: no exterior)")
        if args.metric == 'kottler' and args.metric_param > 0:
            # static coordinates freeze at the cosmological horizon r_c
            # (f -> 0, metric terms -1/f explode under fixed steps); the
            # vacuum bound sqrt(3/Lambda) overestimates r_c by up to ~M,
            # so demand a real margin
            if args.boundary_radius >= 0.9 * np.sqrt(3.0 / args.metric_param):
                raise SystemExit(
                    "Kottler: the escape boundary must sit well inside "
                    "the cosmological horizon — need boundary_radius < "
                    "0.9 sqrt(3/Lambda) (static coordinates freeze at "
                    "r_c and fixed steps explode on the -1/f terms)")
    elif getattr(args, 'metric_param', 0.0):
        raise SystemExit(
            "--metric-param applies to the static families only "
            "(kottler/bardeen/hayward)")
    if args.spin ** 2 + args.charge ** 2 > args.bh_mass ** 2:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    # user string -> SceneConfig.metric (engine.render routing): 'kerr'
    # renders through the horizon-regular Kerr-Schild chart; 'kerr-bl'
    # keeps the Boyer-Lindquist chart (passed through verbatim so the
    # routing in engine.render stays the single source of truth); the
    # static beyond-Kerr names pass through lowercase (render routes them
    # to the generic autodiff engine with metric_param in params[1])
    metric = {'schwarzschild': 'Schwarzschild', 'kerr': 'KerrSchild',
              'kerr-bl': 'kerr-bl', 'kottler': 'kottler',
              'bardeen': 'bardeen', 'hayward': 'hayward',
              'rotating-bardeen': 'rotating-bardeen',
              'rotating-hayward': 'rotating-hayward',
              'kerr-ds': 'kerr-ds'}[args.metric]
    return SceneConfig(
        size=args.size,
        fov_deg=args.fov,
        background=args.background,
        bh_mass=args.bh_mass,
        metric=metric,
        spin=args.spin,
        charge=args.charge,
        metric_param=args.metric_param,
        boundary_radius=args.boundary_radius,
        observer_distance=args.observer_distance,
        integrator=IntegratorConfig(
            steps=args.steps, delta=args.delta, omega=omega,
            order=args.order, rtol=args.rtol, atol=args.atol,
            backend=JAX_BACKENDS.get(args.backend, args.backend),
            dtype=args.dtype),
        patch=PatchConfig(
            center_theta=float(patch_theta), center_phi=float(patch_phi),
            size_theta=float(np.deg2rad(args.bg_patch_size_theta)),
            size_phi=float(np.deg2rad(args.bg_patch_size_phi)),
            flip_theta=args.bg_flip_theta, flip_phi=args.bg_flip_phi),
        n_samples=args.n_samples,
        suppress_warnings=args.suppress_warnings,
        no_flat_trajectories=args.no_flat_trajectories,
    )
