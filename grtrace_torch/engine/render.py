"""End-to-end curved-ray render pipeline: camera -> integrate -> rescue ->
classify -> composite — the torch counterpart of `grtrace.engine.render`.

Everything from the pixel grid to the RGB image runs on one device, with
no host round trip in between; the host loads the texture and fetches one
(5,) count vector at the end.  On a CUDA device the integration runs a
hand-written kernel (engine/integrate_cuda.py: B1 for float32 rays, B2 for
float64 rays, S1 for the sampled trajectories); on the CPU it runs B1's
eager twin for float32 rays and the 16-row integrator for float64 rays, as
the JAX package does, and S1's twin for the trajectories.  `render`
also routes Kerr and charged scenes to the Kerr-Schild chart and 'kerr-bl'
scenes to the Boyer-Lindquist one (engine/render_generic.py), and runs
the adaptive antialiasing pass (engine/aa.py) when asked; the other metric
families raise NotImplementedError.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..io.scene import SceneConfig
from ..physics.camera import camera_rays
from ..physics.coords import rotate_x, spherical_to_cartesian
from . import classify as _classify
from .integrate import integrate_dispatch, integrate_full_dispatch
from .metrics import RenderMetrics

MAX_TRAJ_POINTS = 1000  # reference cap per sampled ray


class RenderResult:
    """Everything one render produced.

    Per-pixel tensors stay on the device until first accessed: reading an
    attribute (image, cls, final_q, final_th, final_ph, q0, p0, alpha0,
    heading, beta, n_steps, status and, after antialiasing, aa_mask)
    fetches it to the host once and caches it as a numpy array.
    """

    _FIELDS = ("image", "cls", "final_q", "final_th", "final_ph", "q0", "p0",
               "alpha0", "heading", "beta", "n_steps", "status", "aa_mask")

    def __init__(self, device_arrays: dict, counts: dict,
                 sampled_indices=None, sampled_trajectories=None):
        self._dev = device_arrays
        self._cache: dict = {}
        self.counts = counts
        self.sampled_indices = sampled_indices    # (K, 2) (i, j)
        self.sampled_trajectories = sampled_trajectories  # list of (P, 3)

    def __getattr__(self, name):
        if name in type(self)._FIELDS:
            cache = self.__dict__["_cache"]
            if name not in cache:
                cache[name] = self.__dict__["_dev"][name].cpu().numpy()
            return cache[name]
        raise AttributeError(name)

    def device(self, name):
        """The raw device tensor (no host transfer)."""
        return self._dev[name]

    def has(self, name):
        """Whether an optional per-pixel field (e.g. the disk mode's
        'evpa') was produced by this render."""
        return name in self._dev


def render_pixels(bg_array, obs_x, fov, mass, boundary_radius,
                  steps, delta, omega,
                  patch_center_theta, patch_center_phi,
                  patch_size_theta, patch_size_phi,
                  *, height, width, flip_theta=False, flip_phi=False,
                  has_background=True, dtype=torch.float32, backend="auto",
                  order=2):
    """The device pipeline for one frame, on bg_array's device.

    Scalars are Python floats; they are rounded to `dtype` as 0-dim tensors
    on the device, as the JAX pipeline receives them.  Returns a dict of
    per-pixel tensors plus the (5,) count vector.
    """
    device = bg_array.device

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    obs_x_t, mass_t = scalar(obs_x), scalar(mass)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    q0, p0, alpha0, heading, beta = camera_rays(
        obs_pos, scalar(fov), height, width, mass_bh=mass_t, dtype=dtype,
        device=device)

    n = height * width
    # camera rays are folded into the equatorial plane, which licenses the
    # equatorial integrators (B1, B2); they round their scalars to dtype on
    # the host
    final_q, final_p, status, n_steps = integrate_dispatch(
        q0.reshape(n, 4), p0.reshape(n, 4), steps, float(delta),
        2.0 * float(mass), float(boundary_radius), float(omega),
        backend=backend, equatorial=True, order=order)
    final_q = final_q.reshape(height, width, 4)

    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        final_q, alpha0, beta, rs=2.0 * mass_t, r_obs_x=obs_x_t,
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)

    image = _classify.composite(cls, u01, v01, bg_array)

    return {
        "image": image,
        "cls": cls,
        "final_q": final_q,
        "final_th": th_csv,
        "final_ph": ph_csv,
        "q0": q0,
        "p0": p0,
        "alpha0": alpha0,
        "heading": heading,
        "beta": beta,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "count_vec": _classify.count_vector(cls),
    }


def _untimed(name):
    return contextlib.nullcontext()


def _sample_trajectories(q0, p0, beta, sampled_ij, scene: SceneConfig, dtype,
                         stage=_untimed):
    """Re-integrate K sampled rays with decimated trajectory capture (kernel
    S1 on the card, its eager twin on the CPU: `integrate_full_dispatch`;
    the part stage "sample_trajectories/s1"), un-fold by beta, convert to
    Cartesian (float64, on the host; "sample_trajectories/to_cartesian")."""
    h, w = scene.image_size
    flat_idx = torch.as_tensor(sampled_ij[:, 0] * w + sampled_ij[:, 1],
                               device=q0.device)
    q0s = q0.reshape(-1, 4)[flat_idx]
    p0s = p0.reshape(-1, 4)[flat_idx]
    betas = beta.reshape(-1)[flat_idx].cpu().double()

    integ = scene.integrator
    with stage("sample_trajectories/s1"):
        traj = integrate_full_dispatch(
            q0s.to(dtype).contiguous(), p0s.to(dtype).contiguous(),
            integ.steps, integ.delta, 2.0 * scene.bh_mass,
            scene.boundary_radius, float(integ.omega),
            n_keep=min(MAX_TRAJ_POINTS, integ.steps), order=integ.order)
    with stage("sample_trajectories/to_cartesian"):
        return trajectories_to_cartesian(traj, betas)


def trajectories_to_cartesian(traj, betas):
    """(K, P, 4) records of (t, r, theta, phi) -> K (P, 3) float64 numpy
    arrays, each un-folded by its ray's beta, in Cartesian coordinates (on
    the host)."""
    traj = traj.cpu().double()
    out = []
    for k in range(traj.shape[0]):
        pts = traj[k]
        x, y, z = spherical_to_cartesian(pts[:, 1], pts[:, 2], pts[:, 3])
        x, y, z = rotate_x(x, y, z, betas[k])
        out.append(torch.stack([x, y, z], dim=-1).numpy())
    return out


# scene.metric -> the static family of the generic engine
STATIC_NAMES = {"kottler": "Kottler", "sds": "Kottler", "bardeen": "Bardeen",
                "hayward": "Hayward"}
# scene.metric -> the rotating regular family of the generic engine
ROTATING_NAMES = {"rotating-bardeen": "RotatingBardeen",
                  "rotatingbardeen": "RotatingBardeen",
                  "rotating-hayward": "RotatingHayward",
                  "rotatinghayward": "RotatingHayward"}
# scene.metric -> Kerr-de Sitter's Carter chart
KDS_NAMES = ("kerr-ds", "kerrds", "kerr-de-sitter")


def _route(scene):
    """The chart `render` takes: 'Kerr' (Boyer-Lindquist, scene.metric
    'kerr-bl' / 'kerrbl'), 'KerrSchild' (Kerr and charged Schwarzschild,
    which is Reissner-Nordstrom there), the static family 'Kottler'
    ('kottler' / 'sds'), 'Bardeen' or 'Hayward', the rotating regular
    family 'RotatingBardeen' or 'RotatingHayward', Kerr-de Sitter's
    'KerrDS' ('kerr-ds' / 'kerrds' / 'kerr-de-sitter'), or 'Schwarzschild'
    for the headline path; raises NotImplementedError for any other
    metric."""
    metric = getattr(scene, "metric", "Schwarzschild").lower()
    if metric in ("kerr-bl", "kerrbl"):
        return "Kerr"
    if metric in STATIC_NAMES:
        return STATIC_NAMES[metric]
    if metric in ROTATING_NAMES:
        return ROTATING_NAMES[metric]
    if metric in KDS_NAMES:
        return "KerrDS"
    charged = float(getattr(scene, "charge", 0.0)) != 0.0
    if (metric in ("kerr", "kerrschild", "kerr-schild")
            or (metric == "schwarzschild" and charged)):
        return "KerrSchild"
    if metric != "schwarzschild":
        raise NotImplementedError(
            f"grtrace_torch renders no metric {scene.metric!r}")
    return "Schwarzschild"


def render(scene: SceneConfig, *, bg_array=None, n_samples=None, seed=0,
           dtype=None, metrics: RenderMetrics | None = None, aa_samples=None,
           device="cuda") -> RenderResult:
    """Full-frame render on `device`: the headline Schwarzschild path, or
    the Kerr-Newman render of engine/render_generic.py, as `grtrace.render`
    routes them: in the Kerr-Schild chart for scene.metric in ('kerr',
    'kerrschild', 'kerr-schild') and for a charged Schwarzschild scene, in
    the Boyer-Lindquist chart for 'kerr-bl' / 'kerrbl', in the static chart
    for 'kottler' / 'sds', 'bardeen' and 'hayward' (scene.metric_param in
    the second params slot), in the mass-function Kerr-Schild chart for
    'rotating-bardeen' / 'rotating-hayward' (scene.spin in the second
    slot, scene.metric_param in the third), in Kerr-de Sitter's Carter
    chart for 'kerr-ds' (scene.spin, and Lambda = scene.metric_param in
    the third slot).

    bg_array: (th, tw, 3) uint8 numpy array or tensor, or None.  dtype: a
    torch dtype, by default the scene's integrator dtype.  metrics:
    optional RenderMetrics to fill with stage timings and throughput.
    device defaults to 'cuda' and raises when no GPU is present; pass
    device='cpu' for the plain torch path.  aa_samples = s (>= 2) runs
    the adaptive edge-refinement pass (engine/aa.py) inside the device
    pipeline: s x s stratified sub-rays re-traced, through the render's
    own kernel, for the boundary pixels, their colours averaged into the
    image (result.device('aa_mask') marks them); the class map, counts and
    CSV fields keep the centre sample.
    """
    chart = _route(scene)
    if chart in STATIC_NAMES.values():
        # the family parameter rides the second params slot, charge 0
        from .render_generic import render_generic
        return render_generic(scene, metric=chart, bg_array=bg_array,
                              spin=float(getattr(scene, "metric_param", 0.0)),
                              charge=0.0, dtype=dtype, n_samples=n_samples,
                              seed=seed, metrics=metrics,
                              aa_samples=aa_samples, device=device)
    if chart in ROTATING_NAMES.values() or chart == "KerrDS":
        # the family parameter (Kerr-de Sitter's Lambda) rides the charge
        # slot
        from .render_generic import render_generic
        return render_generic(scene, metric=chart, bg_array=bg_array,
                              spin=scene.spin,
                              charge=float(getattr(scene, "metric_param",
                                                   0.0)),
                              dtype=dtype, n_samples=n_samples, seed=seed,
                              metrics=metrics, aa_samples=aa_samples,
                              device=device)
    if chart != "Schwarzschild":
        from .render_generic import render_generic
        return render_generic(scene, metric=chart, bg_array=bg_array,
                              dtype=dtype, n_samples=n_samples, seed=seed,
                              metrics=metrics, aa_samples=aa_samples,
                              device=device)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the plain torch path")

    # without metrics the stages are not timed, so nothing synchronizes
    # the card but the one count fetch
    stage = metrics.stage if metrics is not None else _untimed
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = torch.float64 if integ.dtype == "float64" else torch.float32
    has_bg = bg_array is not None
    with stage("texture_upload"):
        bg_dev = (torch.as_tensor(np.asarray(bg_array), dtype=torch.uint8,
                                  device=device) if has_bg
                  else torch.zeros((1, 1, 3), dtype=torch.uint8,
                                   device=device))

    with stage("device_pipeline"):
        out = render_pixels(
            bg_dev, scene.observer_distance, scene.fov, scene.bh_mass,
            scene.boundary_radius, integ.steps, integ.delta,
            float(integ.omega),
            scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype,
            backend=integ.backend, order=integ.order)
        if aa_samples:
            from .aa import refine_edges_schwarzschild
            with stage("device_pipeline/aa"):
                out["image"], out["aa_mask"] = refine_edges_schwarzschild(
                    out["cls"], out["image"], bg_dev,
                    scene.observer_distance, scene.fov, scene.bh_mass,
                    scene.boundary_radius, integ.steps, integ.delta,
                    float(integ.omega),
                    scene.patch.center_theta, scene.patch.center_phi,
                    scene.patch.size_theta, scene.patch.size_phi,
                    height=h, width=w, samples=int(aa_samples),
                    order=integ.order, backend=integ.backend,
                    flip_theta=scene.patch.flip_theta,
                    flip_phi=scene.patch.flip_phi,
                    has_background=has_bg, dtype=dtype, stage=stage)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4]}
    if metrics is not None:  # costs one (H, W) reduction and fetch
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())

    n_samples = scene.n_samples if n_samples is None else n_samples
    sampled_ij = None
    sampled_trajs = None
    if n_samples and n_samples > 0:
        with stage("sample_trajectories"):
            rng = np.random.default_rng(seed)
            flat = rng.choice(h * w, size=min(n_samples, h * w),
                              replace=False)
            sampled_ij = np.stack([flat // w, flat % w], axis=-1)
            sampled_trajs = _sample_trajectories(
                out["q0"], out["p0"], out["beta"], sampled_ij, scene, dtype,
                stage)

    return RenderResult(out, counts, sampled_indices=sampled_ij,
                        sampled_trajectories=sampled_trajs)
