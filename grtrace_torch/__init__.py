"""grtrace_torch — the PyTorch and CUDA port of grtrace.

The Schwarzschild inverse ray tracer (folded pinhole camera, compensated
FANTASY integration, exact-predicate rescue, classification and
compositing) and the Kerr / Kerr-Newman one in the Kerr-Schild chart
(Cartesian camera, Kerr-Schild FANTASY flows with the null-invariant
guard, exact Bardeen rescue), and the thin accretion disk around a Kerr
hole (`render_disk`: inclined camera, first-equatorial-crossing capture,
redshift shading), and the photon-ring subrings of a transparent disk
(`render_subrings`: every image order as its own layer, with the
photon-shell theory of physics/photon_shell.py beside it, and their u-v
signatures through engine/visibility.py), with
Walker-Penrose polarization maps (`bfield`) and a camera on a circular
worldline (`camera_omega`), geodesic transfer maps that re-shade a disk
without tracing (`TransferMap`, `reshade`), orbiting hot-spot movies
(`render_hotspot`, `hotspot_from_transfer`), the
reference-compatible `SchwarzschildIntegrator` for rays in any plane,
adaptive edge antialiasing on every render path (`aa_samples`,
engine/aa.py), the EinsteinPy-compatible geodesics (`compat.Geodesic`,
`Nulllike`, `Timelike`), the shadow, lensing and reverberation observables
(engine/shadow.py, lensing.py, echo.py), and
checkpoint / resume of long integrations (engine/checkpoint.py), on
tensors of any torch device.  On an NVIDIA Hopper GPU the integration
runs hand-written CUDA kernels (csrc/fantasy_eqc.cu in its compensated,
float64 and chunk layouts, csrc/fantasy_schw16.cu in integrate, record
and trace mode, csrc/fantasy_ks.cu in plain, disk and subring mode,
csrc/fantasy_gen.cu); on the CPU it runs their eager twins.
The JAX package `grtrace` is the reference this package is tested
against; this package never imports it, nor jax.
"""
from .io.scene import (BlackHole, IntegratorConfig, Observer, PatchConfig,
                       Photon, SceneConfig, apply_relative_offsets,
                       from_jax_scene)
from .engine.render import RenderResult, render, render_pixels
from .engine.integrate import SchwarzschildIntegrator
from .engine.disk import (DiskConfig, from_jax_disk, render_disk,
                          save_disk_maps)
from .engine.hotspot import HotspotConfig, from_jax_hotspot, render_hotspot
from .engine.subring import (polarized_moments, render_subrings,
                             save_subring_maps, subring_summary,
                             subring_visibilities)
from .io.transfer import TransferMap, hotspot_from_transfer, reshade

__version__ = "0.1.0"

__all__ = [
    "BlackHole", "Observer", "Photon", "PatchConfig", "IntegratorConfig",
    "SceneConfig", "apply_relative_offsets", "from_jax_scene", "RenderResult", "render",
    "render_pixels", "SchwarzschildIntegrator", "DiskConfig",
    "from_jax_disk", "render_disk", "save_disk_maps", "render_subrings",
    "subring_summary", "subring_visibilities", "save_subring_maps",
    "polarized_moments", "HotspotConfig",
    "from_jax_hotspot", "render_hotspot", "TransferMap", "reshade",
    "hotspot_from_transfer", "__version__",
]
