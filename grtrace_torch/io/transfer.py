"""Geodesic transfer maps: trace once, re-shade without tracing — the torch
counterpart of `grtrace.io.transfer`, in the same file format.

Every disk-shading question (temperature law, emissivity index, exposure,
blackbody color, hot-spot movies, polarization for another field geometry)
reads only the per-pixel equatorial-crossing invariants (hit_q, hit_p,
status) and the camera and annulus geometry.  A `TransferMap` keeps those
invariants as host numpy arrays and persists them in one compressed .npz
with a JSON sidecar (the `scalars` array), so a map written by either
package loads in the other.

Reshading runs `engine.disk.run_shading`, the function `render_disk`
shades with, on the device asked for (the card by default).  A reshade
with the trace-time knobs reproduces the render's disk pixels byte for
byte when it runs on the device and in the dtype of the render.  A map
traced on the card and reshaded on the CPU is not byte-exact: the two
devices round transcendental functions differently.

Workflow:

    result = render_disk(scene, disk)
    TransferMap.from_result(result, scene, disk).save("scene.transfer.npz")
    tm = TransferMap.load("scene.transfer.npz")
    res2 = reshade(tm, profile="novikov", t_peak=12000.0)
    movie = hotspot_from_transfer(tm, HotspotConfig(sigma=0.4))
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_FORMAT_VERSION = 1


@dataclasses.dataclass
class TransferMap:
    """Per-pixel geodesic crossing invariants and the geometry the shading
    needs; every array is host numpy."""

    status: np.ndarray          # (H, W) int32 engine status (3 = disk hit)
    hit_q: np.ndarray           # (H, W, 4) Kerr-Schild crossing position
    hit_p: np.ndarray           # (H, W, 4) crossing covariant momentum
    image: np.ndarray           # (H, W, 3) uint8 render (sky + shadow)
    params: np.ndarray          # (3,) mass, spin, charge
    obs_pos: np.ndarray         # (3,) camera position (looking at the hole)
    fov: float                  # radians
    r_in: float                 # disk annulus (the capture geometry, fixed
    r_out: float                # at trace time)
    prograde: bool              # emitter flow direction at trace time
    meta: dict                  # shading defaults + provenance (JSON)

    @property
    def shape(self):
        return self.status.shape

    @classmethod
    def from_result(cls, result, scene, disk):
        """Capture a render_disk result's invariants; `scene` and `disk`
        are the configs it ran with, whose shading knobs become the
        reshade defaults in `meta`."""
        from .. import __version__
        from ..engine.disk import (disk_observer_position,
                                   resolve_camera_omega)

        r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
        camera_moving, camera_omega = resolve_camera_omega(scene, disk)
        meta = {
            "format": _FORMAT_VERSION,
            "grtrace": f"grtrace_torch {__version__}",
            # shading defaults (reshade(None) -> these)
            "t_peak": float(disk.t_peak),
            "exposure": float(disk.exposure),
            "profile": disk.profile,
            "bfield": disk.bfield,
            "emissivity_index": float(disk.emissivity_index),
            # the camera worldline baked into the traced rays; an explicit
            # omega 0.0 still selects the boosted-tetrad camera, hence
            # camera_moving beside camera_omega
            "camera_omega": float(camera_omega),
            "camera_moving": bool(camera_moving),
            # provenance (informational)
            "steps": int(scene.integrator.steps),
            "delta": float(scene.integrator.delta),
            "order": int(scene.integrator.order),
            "backend": scene.integrator.backend,
            "dtype": scene.integrator.dtype,
        }

        def host(name):
            return result.device(name).cpu().numpy()

        return cls(
            status=host("status").astype(np.int32),
            hit_q=host("hit_q"), hit_p=host("hit_p"),
            image=host("image").astype(np.uint8),
            params=np.array([scene.bh_mass, scene.spin, scene.charge],
                            np.float64),
            obs_pos=np.asarray(disk_observer_position(scene, disk),
                               np.float64),
            fov=float(scene.fov), r_in=float(r_in), r_out=float(disk.r_out),
            prograde=bool(disk.prograde), meta=meta)

    def save(self, path):
        """One compressed .npz; the scalars and meta ride a JSON array."""
        scalars = {"fov": self.fov, "r_in": self.r_in, "r_out": self.r_out,
                   "prograde": self.prograde, "meta": self.meta}
        np.savez_compressed(
            path, status=self.status, hit_q=self.hit_q, hit_p=self.hit_p,
            image=self.image, params=self.params, obs_pos=self.obs_pos,
            scalars=np.frombuffer(json.dumps(scalars).encode(),
                                  dtype=np.uint8))

    @classmethod
    def load(cls, path):
        """Read a map written by `save` (or by the JAX package); a newer
        format raises ValueError."""
        with np.load(path) as z:
            scalars = json.loads(bytes(z["scalars"]).decode())
            if scalars["meta"].get("format", 0) > _FORMAT_VERSION:
                raise ValueError(
                    f"transfer map {path!r} written by a newer grtrace "
                    f"(format {scalars['meta']['format']} > "
                    f"{_FORMAT_VERSION})")
            return cls(
                status=z["status"], hit_q=z["hit_q"], hit_p=z["hit_p"],
                image=z["image"], params=z["params"], obs_pos=z["obs_pos"],
                fov=scalars["fov"], r_in=scalars["r_in"],
                r_out=scalars["r_out"], prograde=scalars["prograde"],
                meta=scalars["meta"])


def _device(device, caller):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda') needs a CUDA GPU; pass "
                           f"device='cpu' to run on the CPU")
    return device


def reshade(tm: TransferMap, *, t_peak=None, exposure=None, profile=None,
            prograde=None, bfield=None, device="cuda"):
    """Re-shade a transfer map under new disk-model knobs, on `device`
    (the card by default; raises without one).

    A knob left None keeps its trace-time value (`tm.meta`, `tm.prograde`);
    with all of them None the disk pixels equal the render's byte for byte
    on the render's device.  `bfield` may differ from trace time ('none'
    turns polarization off): the camera rays the EVPA screen solve needs
    are recomputed from the saved camera geometry.  `prograde` flips the
    emitter flow only; the annulus stays as traced.

    Returns an engine.render.RenderResult with image, status, hit_q,
    hit_p, redshift (and the polarization maps with a field) and counts
    {disk, total}, which engine.disk.save_disk_maps and engine.hotspot
    read like a fresh render."""
    from ..engine.disk import run_shading
    from ..engine.render import RenderResult

    device = _device(device, "reshade")
    t_peak = tm.meta["t_peak"] if t_peak is None else float(t_peak)
    exposure = tm.meta["exposure"] if exposure is None else float(exposure)
    profile = tm.meta["profile"] if profile is None else profile
    prograde = tm.prograde if prograde is None else bool(prograde)
    bfield = tm.meta.get("bfield") if bfield is None else (
        None if bfield == "none" else bfield)
    camera_omega = tm.meta.get("camera_omega", 0.0)

    h, w = tm.shape
    dev = {name: torch.as_tensor(np.asarray(getattr(tm, name)),
                                 device=device)
           for name in ("status", "hit_q", "hit_p", "image")}
    out = run_shading(
        (dev["hit_q"], dev["hit_p"], dev["status"], dev["image"]),
        height=h, width=w, profile=profile, prograde=prograde,
        params=tm.params, obs_pos=tm.obs_pos, fov=tm.fov, r_in=tm.r_in,
        r_out=tm.r_out, t_peak=t_peak, exposure=exposure,
        camera_omega=camera_omega, dtype=dev["hit_q"].dtype, bfield=bfield,
        camera_moving=tm.meta.get("camera_moving", camera_omega != 0.0))
    disk_count = int(out.pop("disk_count"))
    del dev["image"]
    dev.update(out)
    return RenderResult(dev, {"disk": disk_count, "total": int(h * w)})


def hotspot_from_transfer(tm: TransferMap, hotspot=None, *,
                          frames_per_chunk=None, device="cuda"):
    """Hot-spot movie and light curve from a saved transfer map, without a
    geodesic step: the redshift map is recomputed from the crossings
    (reshade), then engine.hotspot.hotspot_movie shades the frames."""
    from ..engine.hotspot import hotspot_movie

    res = reshade(tm, device=device)
    return hotspot_movie(
        res.device("image"), res.device("hit_q"), res.device("status"),
        res.device("redshift"), tm.params, tm.r_in, tm.r_out, tm.prograde,
        hotspot, frames_per_chunk=frames_per_chunk,
        camera_omega=tm.meta.get("camera_omega", 0.0))
