"""Scene entities and render configuration (PyTorch port).

A copy of `grtrace.io.scene`: that module is numpy-only, but importing it
pulls in jax through `grtrace/__init__.py`, so the port carries its own.
Field names and defaults are the JAX package's, except that
`IntegratorConfig.backend` names the port's backends ('auto' | 'cuda' |
'torch').  `from_jax_scene` converts a `grtrace.io.scene.SceneConfig` by
duck typing, without importing anything from `grtrace`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BlackHole:
    """Schwarzschild black hole, geometrized units (r_s = 2M)."""
    mass: float = 1.0
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def rs(self) -> float:
        return 2.0 * self.mass


@dataclasses.dataclass
class Observer:
    """Pinhole-camera observer."""
    position: Tuple[float, float, float]
    fov: float                      # radians
    image_size: Tuple[int, int]     # (height, width)


@dataclasses.dataclass
class Photon:
    """Kept for API parity with `grtrace.io.scene.Photon` (defined but
    unused by the reference pipeline)."""
    position: Tuple[float, float, float]
    direction: Tuple[float, float, float]
    mesh_idx: Tuple[int, int]
    collision: Optional[str] = None
    collision_pos: Optional[Tuple[float, float, float]] = None


@dataclasses.dataclass
class PatchConfig:
    """Background-patch geometry on the boundary sphere (radians)."""
    center_theta: float = np.pi / 2
    center_phi: float = np.pi
    size_theta: float = np.deg2rad(180)
    size_phi: float = np.deg2rad(360)
    flip_theta: bool = False
    flip_phi: bool = False


@dataclasses.dataclass
class IntegratorConfig:
    """Fixed-step FANTASY symplectic-integrator settings.

    `order` in {2,4,6,8} (Yoshida composition; `steps` counts composed
    steps).  `backend`: 'auto' picks the CUDA kernel for CUDA tensors and
    the plain torch path for CPU tensors; 'cuda' demands the kernel;
    'torch' selects the plain path on any device.
    """
    steps: int = 200_000
    delta: float = 0.01
    omega: float = 1.0
    order: int = 2
    rtol: float = 1e-2      # parsed-but-unused in the reference; kept for
    atol: float = 1e-2      #   flag parity
    backend: str = "auto"   # 'auto' | 'cuda' | 'torch'
    dtype: str = "float32"  # 'float32' | 'float64'


@dataclasses.dataclass
class SceneConfig:
    """Full scene — the same fields as `grtrace.io.scene.SceneConfig`.

    The port renders only uncharged Schwarzschild scenes so far; the other
    metric fields are kept so a JAX scene converts field for field, and
    `engine.render.render` raises NotImplementedError for them.
    """
    size: int = 200
    fov_deg: float = 80.0
    background: Optional[str] = "images/backgrounds/milky-way-equirec.jpg"
    bh_mass: float = 1.0
    metric: str = "Schwarzschild"
    spin: float = 0.0
    charge: float = 0.0
    metric_param: float = 0.0
    boundary_radius: float = 31.0
    observer_distance: float = 30.0
    integrator: IntegratorConfig = dataclasses.field(default_factory=IntegratorConfig)
    patch: PatchConfig = dataclasses.field(default_factory=PatchConfig)
    n_samples: int = 20
    suppress_warnings: bool = False
    no_flat_trajectories: bool = False

    def __post_init__(self):
        # the r >= 100 'numerical error' class is tested before the
        # boundary, so the domain must stay inside it
        if not (0.0 < self.boundary_radius < 100.0):
            raise ValueError(
                f"boundary_radius must be in (0, 100) (the reference's "
                f"r >= 100 numerical-error sentinel caps the domain); got "
                f"{self.boundary_radius}")
        if self.observer_distance >= self.boundary_radius:
            raise ValueError(
                f"observer_distance ({self.observer_distance}) must be "
                f"inside boundary_radius ({self.boundary_radius})")

    @property
    def fov(self) -> float:
        return float(np.radians(self.fov_deg))

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.size, self.size)

    def black_hole(self) -> BlackHole:
        return BlackHole(mass=self.bh_mass)

    def observer(self) -> Observer:
        return Observer(position=(self.observer_distance, 0.0, 0.0),
                        fov=self.fov, image_size=self.image_size)


# JAX backend names -> the port's
JAX_BACKENDS = {"auto": "auto", "pallas": "cuda", "xla": "torch"}


def from_jax_scene(scene) -> SceneConfig:
    """Convert a `grtrace.io.scene.SceneConfig` (duck-typed: any object
    with the same attributes) into the port's SceneConfig.  The JAX
    backends map as 'pallas' -> 'cuda', 'xla' -> 'torch'."""
    integ = scene.integrator
    patch = scene.patch
    return SceneConfig(
        size=scene.size, fov_deg=scene.fov_deg, background=scene.background,
        bh_mass=scene.bh_mass, metric=scene.metric, spin=scene.spin,
        charge=scene.charge, metric_param=scene.metric_param,
        boundary_radius=scene.boundary_radius,
        observer_distance=scene.observer_distance,
        integrator=IntegratorConfig(
            steps=integ.steps, delta=integ.delta, omega=integ.omega,
            order=integ.order, rtol=integ.rtol, atol=integ.atol,
            backend=JAX_BACKENDS.get(integ.backend, integ.backend),
            dtype=integ.dtype),
        patch=PatchConfig(
            center_theta=patch.center_theta, center_phi=patch.center_phi,
            size_theta=patch.size_theta, size_phi=patch.size_phi,
            flip_theta=patch.flip_theta, flip_phi=patch.flip_phi),
        n_samples=scene.n_samples,
        suppress_warnings=scene.suppress_warnings,
        no_flat_trajectories=scene.no_flat_trajectories)


def apply_relative_offsets(theta_base_deg, phi_base_deg,
                           dtheta_deg=0.0, dphi_deg=0.0):
    """Observer-relative patch aiming (reference simulation/utils.py:27-36):
    (theta, phi) in radians."""
    theta = np.clip(np.deg2rad(theta_base_deg) + np.deg2rad(dtheta_deg),
                    0.0, np.pi)
    phi = (np.deg2rad(phi_base_deg) + np.deg2rad(dphi_deg)) % (2 * np.pi)
    return theta, phi
