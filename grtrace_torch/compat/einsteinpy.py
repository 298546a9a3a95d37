"""EinsteinPy-compatible `Geodesic` / `Nulllike` / `Timelike` — the torch
counterpart of `grtrace.compat.einsteinpy`, on the port's trace kernels.

The reference's CPU ground truth is EinsteinPy's `Nulllike` geodesic;
these classes keep EinsteinPy's signatures, defaults and errors so that
its users migrate unchanged, and integrate on the card:

  * Schwarzschild: kernel T1, the trace mode of csrc/fantasy_schw16.cu
    (`engine.integrate.trajectory_dispatch`; B3's fused step);
  * Kerr and Kerr-Newman: kernel T2, the Boyer-Lindquist trace mode of
    csrc/fantasy_gen.cu (`engine.integrate_generic.trajectory_generic`);

with the CPU taking the kernels' eager twins only when the caller passes
device='cpu' (the port's one addition to the signatures).  Everything runs
in float64, as EinsteinPy does.

Semantics (EinsteinPy's, as in JAX's module):
  * momentum = (p_r, p_th, p_ph); p_t closes the mass shell g^{ab} p_a p_b
    = -mu^2 (mu = 0 null, mu = 1 timelike) on EinsteinPy's `_P()` branch
    (p_t < 0); the flows integrate H = 1/2 g^ab p_a p_b for any covector,
    so `Timelike` runs the same kernels and only its closure differs
    (physics/timelike.py);
  * no early exit: every step of the budget runs, whatever the horizon
    does;
  * `trajectory` returns (step_indices, data), data[k] the state after step
    k + 1: (t, x, y, z, p_t, p_r, p_th, p_ph) with return_cartesian=True,
    (t, r, th, ph, p_t, p_r, p_th, p_ph) otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics import nullcond, spacetime
from ..physics.timelike import build_timelike_4momentum

METRICS = ("Schwarzschild", "Kerr", "KerrNewman")


class Geodesic:
    """Drop-in analog of einsteinpy.geodesic.Geodesic.

    Parameters follow EinsteinPy: position=(r, th, ph), momentum=(p_r,
    p_th, p_ph), steps, delta, omega, order, return_cartesian,
    suppress_warnings (accepted, unused), time_like (False -> photon, True
    -> unit-mass particle), metric in {"Schwarzschild", "Kerr",
    "KerrNewman"} with metric_params=(a,) or (a, Q) for KerrNewman.
    Schwarzschild runs kernel T1, Kerr and Kerr-Newman kernel T2.
    device='cuda' (the default) needs a GPU and raises RuntimeError
    without one; device='cpu' runs the kernels' eager twins.
    """

    def __init__(self, metric="Schwarzschild", metric_params=(0.0,),
                 position=(10.0, np.pi / 2, 0.0),
                 momentum=(1.0, 0.0, 1.0),
                 steps=50, delta=0.5, omega=1.0, order=2,
                 return_cartesian=True,
                 suppress_warnings=False, time_like=False, mass=1.0, *,
                 device="cuda"):
        if metric not in METRICS:
            raise NotImplementedError(
                f"metric {metric!r}: supported metrics are Schwarzschild, "
                "Kerr and KerrNewman")
        spin = float(metric_params[0]) if metric_params else 0.0
        charge = (float(metric_params[1])
                  if metric == "KerrNewman" and len(metric_params) > 1
                  else 0.0)
        if metric == "Schwarzschild" and spin != 0.0:
            raise ValueError("Schwarzschild requires spin a == 0; "
                             "use metric='Kerr' for a != 0")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(device='cuda') needs "
                               f"a CUDA GPU; pass device='cpu' for the CPU")
        self.spin = spin
        self.charge = charge
        self.device = device

        self.metric = metric
        self.steps = int(steps)
        self.delta = float(delta)
        self.omega = float(omega)
        self.order = int(order)
        self.return_cartesian = bool(return_cartesian)
        self.time_like = bool(time_like)
        self.mass = float(mass)

        pos = torch.tensor(position, dtype=torch.float64)
        mom = torch.tensor(momentum, dtype=torch.float64)
        params = torch.tensor([self.mass, self.spin, self.charge],
                              dtype=torch.float64)
        # the EinsteinPy `_P()` root: p_t < 0, E = -p_t > 0
        if self.time_like:
            p4 = build_timelike_4momentum(mom, pos, params,
                                          spacetime.kerr_g_inv, mu=1.0,
                                          future=True)
        elif metric in ("Kerr", "KerrNewman"):
            p4 = spacetime.build_null_4momentum(mom, pos, params,
                                                spacetime.kerr_g_inv,
                                                future=False)
        else:
            p4 = nullcond.build_null_4momentum(mom, pos, mass_bh=self.mass,
                                               future=False)
        self.position = np.array([0.0, *pos.tolist()])
        self.momentum = p4.numpy()

        self._qs = None
        self._ps = None

    def _integrate(self):
        """(qs, ps), each (steps, 4) float64 host arrays, traced once."""
        if self._qs is None:
            q0 = torch.tensor(self.position, dtype=torch.float64,
                              device=self.device)
            p0 = torch.tensor(self.momentum, dtype=torch.float64,
                              device=self.device)
            if self.metric in ("Kerr", "KerrNewman"):
                from ..engine.integrate_generic import trajectory_generic
                qs, ps = trajectory_generic(
                    q0, p0, self.steps, self.delta,
                    [self.mass, self.spin, self.charge], self.omega,
                    order=self.order, metric="Kerr")
            else:
                from ..engine.integrate import trajectory_dispatch
                out = trajectory_dispatch(q0[None], p0[None], self.steps,
                                          self.delta, 2.0 * self.mass,
                                          self.omega, order=self.order)[0]
                qs, ps = out[:, :4], out[:, 4:]
            self._qs = qs.cpu().numpy()
            self._ps = ps.cpu().numpy()
        return self._qs, self._ps

    @property
    def trajectory(self):
        """(step_indices, (steps, 8) array) — EinsteinPy layout."""
        qs, ps = self._integrate()
        t = qs[:, 0]
        if self.return_cartesian:
            r, th, ph = qs[:, 1], qs[:, 2], qs[:, 3]
            sin_th = np.sin(th)
            cols = [t, r * sin_th * np.cos(ph), r * sin_th * np.sin(ph),
                    r * np.cos(th)]
        else:
            cols = [t, qs[:, 1], qs[:, 2], qs[:, 3]]
        data = np.stack(cols + [ps[:, 0], ps[:, 1], ps[:, 2], ps[:, 3]],
                        axis=-1)
        return np.arange(self.steps), data

    def __repr__(self):
        return (f"{type(self).__name__}(metric={self.metric!r}, "
                f"steps={self.steps}, delta={self.delta}, "
                f"omega={self.omega})")


class Nulllike(Geodesic):
    """einsteinpy.geodesic.Nulllike: a photon (mass shell 0).  EinsteinPy's
    subclass pins time_like=False and does not take it: passing it is a
    TypeError, as upstream."""

    def __init__(self, metric="Schwarzschild", metric_params=(0.0,),
                 position=(10.0, np.pi / 2, 0.0),
                 momentum=(1.0, 0.0, 1.0),
                 steps=50, delta=0.5, omega=1.0, order=2,
                 return_cartesian=True,
                 suppress_warnings=False, mass=1.0, *, device="cuda"):
        super().__init__(metric=metric, metric_params=metric_params,
                         position=position, momentum=momentum,
                         steps=steps, delta=delta, omega=omega, order=order,
                         return_cartesian=return_cartesian,
                         suppress_warnings=suppress_warnings,
                         time_like=False, mass=mass, device=device)


class Timelike(Geodesic):
    """einsteinpy.geodesic.Timelike: a unit-mass particle (mu = 1) on the
    same kernels; the conserved Hamiltonian is -1/2 instead of 0.  As in
    JAX's class, bound orbits over many radial periods need omega near 1
    (EinsteinPy's default): at omega = 0.01 the two phase-space copies can
    unbind."""

    def __init__(self, metric="Schwarzschild", metric_params=(0.0,),
                 position=(40.0, np.pi / 2, 0.0),
                 momentum=(0.0, 0.0, 4.0),
                 steps=50, delta=0.5, omega=1.0, order=2,
                 return_cartesian=True,
                 suppress_warnings=False, mass=1.0, *, device="cuda"):
        super().__init__(metric=metric, metric_params=metric_params,
                         position=position, momentum=momentum,
                         steps=steps, delta=delta, omega=omega, order=order,
                         return_cartesian=return_cartesian,
                         suppress_warnings=suppress_warnings,
                         time_like=True, mass=mass, device=device)
