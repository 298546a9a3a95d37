"""Re-shade a saved geodesic transfer map — the port's
`grtrace.cli.reshade`: disk-model exploration at shading cost, with no
geodesic step (kernel B6 is not launched).

    # trace once (the card; writes scene.transfer.npz beside the render):
    python -m grtrace_torch.cli.main --disk --metric kerr --spin 0.9 \
        --save-transfer scene.transfer.npz --no-plots
    # then explore models:
    python -m grtrace_torch.cli.reshade --transfer scene.transfer.npz \
        --disk-profile novikov --disk-temp 12000 --out-dir nt/
    python -m grtrace_torch.cli.reshade --transfer scene.transfer.npz \
        --disk-bfield toroidal --out-dir pol/
    # emissivity-index scan: one line profile per q
    python -m grtrace_torch.cli.reshade --transfer scene.transfer.npz \
        --disk-emissivity 2 3 4 --out-dir qscan/

Writes manual_output.png and the disk science products (redshift_map,
line_profile and, with a field, polarization_map CSVs; their figures
unless --no-plots, which the JAX driver does not have) for every knob
combination.  The shading runs on the card (--device cpu for the CPU).
Maps written by either package load in the other.
"""
from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="re-shade a saved geodesic transfer map")
    p.add_argument('--transfer', type=str, required=True,
                   help='transfer-map .npz written by --save-transfer')
    p.add_argument('--disk-temp', type=float, default=None,
                   help='peak color temperature (K); default: as traced')
    p.add_argument('--disk-exposure', type=float, default=None,
                   help='tone-mapping gain; default: as traced')
    p.add_argument('--disk-profile', choices=('shakura', 'novikov'),
                   default=None, help='temperature law; default: as traced')
    p.add_argument('--disk-bfield',
                   choices=('vertical', 'toroidal', 'radial', 'none'),
                   default=None,
                   help='polarized-imaging field geometry (EVPA maps '
                        'recomputed from the saved camera); default: as '
                        'traced, "none" disables')
    p.add_argument('--disk-retrograde', action='store_true',
                   help='re-shade with counter-rotating emitters (the '
                        'annulus stays as traced)')
    p.add_argument('--disk-emissivity', type=float, nargs='+', default=None,
                   help='emissivity index q for the line profile; several '
                        'values write one set of maps each (q<q>/)')
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='shade on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSVs only (the figures need matplotlib)')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ..engine.disk import save_disk_maps
    from ..io import artifacts
    from ..io.transfer import TransferMap, reshade
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.reshade: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.reshade: the figures need "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")
    tm = TransferMap.load(args.transfer)
    res = reshade(tm, t_peak=args.disk_temp, exposure=args.disk_exposure,
                  profile=args.disk_profile, bfield=args.disk_bfield,
                  prograde=False if args.disk_retrograde else None,
                  device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(res.device("image").cpu().numpy(),
                         os.path.join(args.out_dir, "manual_output.png"))
    spin = float(tm.params[1])
    qs = args.disk_emissivity or [tm.meta.get("emissivity_index", 3.0)]
    save_disk_maps(res, args.out_dir, emissivity_index=qs[0], spin=spin,
                   plots=not args.no_plots)
    for q in qs[1:]:
        sub = os.path.join(args.out_dir, f"q{q:g}")
        os.makedirs(sub, exist_ok=True)
        save_disk_maps(res, sub, emissivity_index=q, spin=spin,
                       plots=not args.no_plots)

    h, w = tm.shape
    print(f"reshaded {w}x{h} transfer map ({res.counts['disk']} disk px, "
          f"traced at steps={tm.meta['steps']} delta={tm.meta['delta']}) "
          f"-> {args.out_dir}")
    return res


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
