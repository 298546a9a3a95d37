"""The float32 polarization check: the port against the JAX package as
users run it (x64 off).

    JAX_PLATFORMS=cpu python tools/pol_f32_gap.py [--size 32] [--steps 3000]
    python tools/pol_f32_gap.py --card-out DIR            # on a CUDA card
    JAX_PLATFORMS=cpu python tools/pol_f32_gap.py --transfer DIR

Renders one polarized thin-disk frame (a = 0.9, vertical field, float32;
the default DiskConfig camera, 12 deg above the disk) through
`grtrace.render_disk` and `grtrace_torch.render_disk(device='cpu')`, and
prints, as one JSON line: each package's worst |pol_check - 1| over its
disk pixels, the pixels where the five worst fall (with their emission
radius), and the same statistic when both packages' polarization
functions are fed the port's own emission events and camera rays in
float32 (which separates the arithmetic from the two integrators' hit
points).  pol_check is the norm of the Walker-Penrose screen solve, 1 in
exact arithmetic.

The frame of the card's disk line is too large for the JAX integrator on
the CPU, so it is compared in two halves.  `--card-out DIR` (imports no
JAX) runs `grtrace_torch.cli.main --disk` on the card with that frame's
flags (512x512, 30000 steps, delta 0.02, Novikov-Thorne profile,
vertical field) and writes its transfer map (`disk.transfer.npz`, the JAX
package's format) and the render's own pol_check (`pol_check.npy`) to
DIR (the CLI's CSVs to build/pol_f32_gap/).  `--transfer DIR` then shades that map's emission events with both
packages' `reshade` on the CPU in float32 and prints the worst pixels of
the card's render, of the port's and of JAX's reshade, and JAX's value at
the card's worst pixels; `--jax-render` adds JAX's own render of the
frame on the same flags (its integrator's emission events).

Except with `--card-out`, imports JAX and the JAX package: a comparison,
not part of the port.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _worst(chk, disk, r_hit, k=5):
    """{'max', 'median', 'worst': [(i, j, |chk - 1|, r_hit)]} over disk."""
    dev = np.where(disk, np.abs(chk.astype(np.float64) - 1.0), -1.0)
    flat = np.argsort(dev.ravel())[::-1][:k]
    w = dev.shape[1]
    return {"max": float(dev[disk].max()),
            "median": float(np.median(dev[disk])),
            "disk_pixels": int(disk.sum()),
            "worst": [(int(f // w), int(f % w), float(dev.ravel()[f]),
                       float(r_hit.ravel()[f])) for f in flat]}


CARD_ARGV = ["--size", "512", "--metric", "kerr", "--spin", "0.9", "--disk",
             "--steps", "30000", "--delta", "0.02", "--disk-profile",
             "novikov", "--disk-bfield", "vertical", "--no-plots"]


def card_out(out_dir):
    """The card's polarized frame: its transfer map and pol_check."""
    import contextlib
    import io
    import subprocess

    from grtrace_torch.cli import main as cli_main
    os.makedirs(out_dir, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        res = cli_main.main(CARD_ARGV + [
            "--save-transfer", os.path.join(out_dir, "disk.transfer.npz"),
            "--out-dir", os.path.join(REPO, "build", "pol_f32_gap")])
    chk = res.device("pol_check").cpu().numpy()
    np.save(os.path.join(out_dir, "pol_check.npy"), chk)
    dm = res.device("status").cpu().numpy() == 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"argv": " ".join(CARD_ARGV), "card": card.strip(),
                      "counts": res.counts, "max_abs_pol_check_minus_1":
                      float(np.abs(chk[dm].astype(np.float64) - 1).max())}))


def compare_transfer(in_dir, jax_render=False):
    """Both packages' float32 reshade of the card's map, beside the card's
    own pol_check; with `jax_render`, JAX's own render of the frame too."""
    import torch

    import grtrace_torch
    from grtrace.io import transfer as jtransfer
    from grtrace_torch.physics.spacetime import ks_radius

    path = os.path.join(in_dir, "disk.transfer.npz")
    jtm = jtransfer.TransferMap.load(path)
    ttm = grtrace_torch.TransferMap.load(path)
    card = np.load(os.path.join(in_dir, "pol_check.npy"))
    disk = np.asarray(ttm.status) == 3
    hq = np.asarray(ttm.hit_q, np.float64)
    r_hit = np.asarray(ks_radius(*(torch.tensor(hq[..., k])
                                   for k in (1, 2, 3)), 0.9))
    jchk = np.asarray(jtransfer.reshade(jtm).device("pol_check"))
    tchk = grtrace_torch.reshade(ttm, device="cpu").device(
        "pol_check").numpy()
    out = {"dtype": str(np.asarray(ttm.hit_q).dtype),
           "card": _worst(card, disk, r_hit),
           "port_cpu": _worst(tchk, disk, r_hit),
           "jax": _worst(jchk, disk, r_hit)}
    out["jax_at_card_worst"] = [
        (i, j, float(abs(np.float64(jchk[i, j]) - 1.0)))
        for i, j, _, _ in out["card"]["worst"]]
    out["max_abs_jax_minus_card"] = float(
        np.abs(jchk[disk].astype(np.float64) - card[disk]).max())
    if jax_render:
        # JAX's own frame on the same flags: its integrator's hit points
        import grtrace
        from grtrace.cli import args as jargs
        a = jargs.parse_args([x for x in CARD_ARGV if x != "--no-plots"])
        res = grtrace.render_disk(jargs.scene_from_args(a),
                                  jargs.disk_from_args(a))
        jd = np.asarray(res.status) == 3
        jq = np.asarray(res.device("hit_q"), np.float64)
        jr = np.asarray(ks_radius(*(torch.tensor(jq[..., k])
                                    for k in (1, 2, 3)), 0.9))
        own = np.asarray(res.device("pol_check"))
        out["jax_render"] = _worst(own, jd, jr)
        out["jax_render"]["counts"] = res.counts
        out["jax_render_at_card_worst"] = [
            (i, j, bool(jd[i, j]), float(abs(np.float64(own[i, j]) - 1.0)))
            for i, j, _, _ in out["card"]["worst"]]
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--delta", type=float, default=0.05)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--card-out", metavar="DIR")
    mode.add_argument("--transfer", metavar="DIR")
    ap.add_argument("--jax-render", action="store_true",
                    help="with --transfer: also render the frame through "
                         "grtrace (about 45 minutes on 8 CPU cores at 512x512)")
    args = ap.parse_args(argv)
    if args.card_out:
        return card_out(args.card_out)
    if args.transfer:
        return compare_transfer(args.transfer, args.jax_render)

    import jax.numpy as jnp
    import torch

    import grtrace
    import grtrace_torch
    from grtrace.engine import disk as jdisk
    from grtrace_torch.engine import disk as tdisk
    from grtrace_torch.physics.spacetime import ks_radius

    scene = grtrace.SceneConfig(
        size=args.size, metric="kerr", spin=0.9, background=None,
        n_samples=0, integrator=grtrace.IntegratorConfig(
            steps=args.steps, delta=args.delta, dtype="float32"))
    cfg = dict(bfield="vertical", show_background=False)
    j = grtrace.render_disk(scene, jdisk.DiskConfig(**cfg))
    t = grtrace_torch.render_disk(grtrace_torch.from_jax_scene(scene),
                                  tdisk.DiskConfig(**cfg), device="cpu")

    def hit_radius(hq):
        hq = np.asarray(hq, np.float64)
        return np.asarray(ks_radius(*(torch.tensor(hq[..., k])
                                      for k in (1, 2, 3)), 0.9))

    out = {"size": args.size, "steps": args.steps, "delta": args.delta,
           "jax_x64": bool(jnp.zeros(()).dtype == jnp.float64),
           "counts": {"jax": j.counts, "port": t.counts}}
    jdisk_px = np.asarray(j.status) == 3
    tdisk_px = t.status == 3
    out["jax"] = _worst(np.asarray(j.device("pol_check")), jdisk_px,
                        hit_radius(j.device("hit_q")))
    out["port"] = _worst(t.device("pol_check").numpy(), tdisk_px,
                         hit_radius(t.device("hit_q").numpy()))

    # both polarization functions on the port's emission events and rays
    n = args.size * args.size
    obs = np.asarray(tdisk.disk_observer_position(
        grtrace_torch.from_jax_scene(scene), tdisk.DiskConfig(**cfg)),
        np.float64)
    hq = t.device("hit_q").reshape(n, 4)
    hp = t.device("hit_p").reshape(n, 4)
    q0 = t.device("q0").reshape(n, 4)
    p0 = t.device("p0").reshape(n, 4)
    mask = t.device("status").reshape(n) == 3
    params = (1.0, 0.9, 0.0)
    f32 = torch.float32
    _, _, tchk = tdisk.polarization_fields(
        hq, hp, q0, p0, torch.tensor(obs, dtype=f32),
        torch.tensor(scene.fov, dtype=f32), args.size, args.size,
        torch.tensor(params, dtype=f32), True, "vertical", mask, f32)
    _, _, jchk = jdisk.polarization_fields(
        *(jnp.asarray(x.numpy()) for x in (hq, hp, q0, p0)),
        jnp.asarray(obs, jnp.float32), jnp.float32(scene.fov), args.size,
        args.size, jnp.asarray(params, jnp.float32), True, "vertical",
        jnp.asarray(mask.numpy()), jnp.float32)
    r = hit_radius(hq.numpy()).reshape(args.size, args.size)
    m2 = mask.numpy().reshape(args.size, args.size)
    out["same_events"] = {
        "port": _worst(tchk.numpy().reshape(args.size, args.size), m2, r),
        "jax": _worst(np.asarray(jchk).reshape(args.size, args.size), m2, r)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
