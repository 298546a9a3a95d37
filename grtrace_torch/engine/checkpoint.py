"""Checkpoint / resume for long integrations — the torch counterpart of
`grtrace.engine.checkpoint`, in its single-file npz format.

`integrate_chunked` advances the phase-space-doubled state by bounded
chunks and returns an `IntegrationState`, which `save` writes to an `.npz`
file and `IntegrationState.load` reads back; resume is re-entering the
loop with the loaded carry.  The carry stays a tensor on its device
between chunks; only `save` fetches it.  `advance` runs the chunk through
a CUDA kernel for a carry on a CUDA device and through the kernel's eager
twin for a carry on the CPU:

  * 'generic' — (16, N) rows q1, p1, q2, p2.  On CUDA, kernel B3
    (`integrate_cuda.advance_state_cuda`, the fused flows; the JAX
    package's `advance_state_pallas`); on the CPU, `_advance` (the unfused
    flows of `integrate_batch`, the JAX package's XLA path).
    `_advance_fused` is B3's chunk twin.
  * 'eqc' — (24, N) Kahan-compensated, staggered equatorial rows (the
    headline render's numerics).  `start` applies the opening half-A once,
    chunks run core steps only (kernel B4, `advance_state_eqc_cuda`, or
    its twin `_advance_eqc`), and the read-out closes once — so a chunked
    job is bit-identical to the monolithic kernel B1 or its twin, final_p
    included (the close is eager torch with no FMA).  Requires equatorial
    rays (theta == pi/2, p_theta == 0).

The npz layout is the JAX package's (`state`, `n_steps`, `meta` =
[steps_total, steps_done, layout code], `params` = [delta, rs, r_max,
omega, order], `opened`, `esc`), so a carry written by either package
finishes in the other.  The JAX package's orbax checkpoint directories
(any path not ending in `.npz`) are not supported: they raise ValueError.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..physics.hamiltonian import pack_state, pack_state_eqc, staggered_eqc
from . import integrate_cuda
from .integrate import (STATUS_ALIVE, _in_dtype, classify_final, fused_cores,
                        plain_cores, resolve_backend, schw_true_escape_pred,
                        staggered_close, staggered_cores, staggered_open,
                        substep_params)

LAYOUTS = ("generic", "eqc")  # the npz meta's layout codes 0 and 1


def _npz_only(path):
    if not str(path).endswith(".npz"):
        raise ValueError(
            f"{str(path)!r}: grtrace_torch writes and reads checkpoints as "
            f"single .npz files only; the JAX package's orbax checkpoint "
            f"directories (a path not ending in .npz) are not supported")


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a checkpoint on device='cuda' needs a CUDA GPU; "
                           "pass device='cpu' for the CPU")
    return device


def _rays(q0s, p0s, device):
    """q0s, p0s as tensors: CUDA or CPU tensors stay where they are, other
    arrays go to `device`, their dtype kept."""
    if isinstance(q0s, torch.Tensor) and isinstance(p0s, torch.Tensor):
        return q0s, p0s
    device = _device(device)
    return tuple(torch.as_tensor(np.array(x), device=device)
                 for x in (q0s, p0s))


@dataclasses.dataclass
class IntegrationState:
    """Resumable integrator carry.

    state: (16, N) phase-space rows (q1, p1, q2, p2 x 4) for the 'generic'
        layout, or (24, N) staggered compensated equatorial rows (12 state
        + 12 Kahan deficits) for 'eqc', a tensor on its device
    n_steps: (N,) int32 steps applied so far
    steps_total / steps_done: budget bookkeeping
    delta, rs, r_max, omega, order: the integrator's parameters
    opened: ('eqc' only) (N,) bool — the rays carrying a pending opening
        half-A that the read-out closes (the monolithic kernel's act0)
    esc_pred: (N,) bool exact escape predicate from the launch state, for
        the rescue
    """
    state: torch.Tensor
    n_steps: torch.Tensor
    steps_total: int
    steps_done: int
    delta: float
    rs: float
    r_max: float
    omega: float
    order: int = 2
    layout: str = "generic"
    opened: Optional[torch.Tensor] = None
    esc_pred: Optional[torch.Tensor] = None

    def _raw_qp(self):
        if self.layout == "eqc":
            c = _finalize_eqc(self.state, self.opened, self.delta, self.rs,
                              self.order)
            th = torch.full_like(c[1], torch.pi / 2)
            zero = torch.zeros_like(c[1])
            return (torch.stack([c[0], c[1], th, c[2]], dim=-1),
                    torch.stack([c[3], c[4], zero, c[5]], dim=-1))
        return self.state[0:4].T, self.state[4:8].T

    def _resolve(self):
        """(final_q, final_p, status) with the rescue applied — the
        read-out of the monolithic integrators, from the predicate stored
        at start.  Computed once per state tensor."""
        cached = getattr(self, "_resolved", None)
        if cached is not None and cached[0] is self.state:
            return cached[1]
        q, p = self._raw_qp()
        dtype = self.state.dtype
        fq, status = classify_final(q, p, self.esc_pred,
                                    _in_dtype(self.rs, dtype),
                                    _in_dtype(self.r_max, dtype))
        out = (fq, p, status)
        self._resolved = (self.state, out)
        return out

    @property
    def final_q(self):
        return self._resolve()[0]

    @property
    def final_p(self):
        return self._resolve()[1]

    @property
    def status(self):
        return self._resolve()[2]

    @property
    def done(self) -> bool:
        return (self.steps_done >= self.steps_total
                or not bool((self.status == STATUS_ALIVE).any()))

    def _tree(self) -> dict:
        tree = dict(state=self.state.cpu().numpy(),
                    n_steps=self.n_steps.cpu().numpy(),
                    meta=np.array([self.steps_total, self.steps_done,
                                   LAYOUTS.index(self.layout)]),
                    params=np.array([self.delta, self.rs, self.r_max,
                                     self.omega, float(self.order)]))
        if self.layout != "generic":
            tree["opened"] = self.opened.cpu().numpy().astype(np.uint8)
        if self.esc_pred is not None:
            tree["esc"] = self.esc_pred.cpu().numpy().astype(np.uint8)
        return tree

    def save(self, path: str) -> None:
        """Write the carry to one compressed `.npz` file (the JAX package's
        npz layout); other paths raise ValueError."""
        _npz_only(path)
        np.savez_compressed(path, **self._tree())

    @staticmethod
    def load(path: str, device="cuda") -> "IntegrationState":
        """Read a carry written by `save` or by the JAX package's npz path
        onto `device` (by default the card; device='cpu' for the CPU)."""
        _npz_only(path)
        device = _device(device)
        with np.load(path) as z:
            meta = np.asarray(z["meta"])
            p = np.asarray(z["params"])
            layout = LAYOUTS[int(meta[2])] if meta.shape[0] > 2 else "generic"
            opened = (np.asarray(z["opened"]).astype(bool)
                      if "opened" in z else None)
            esc = _load_esc_pred(z, float(p[1]))
            state = np.asarray(z["state"])
            n_steps = np.asarray(z["n_steps"]).astype(np.int32)

        def dev(x):
            return None if x is None else torch.as_tensor(x, device=device)

        return IntegrationState(
            state=dev(state), n_steps=dev(n_steps),
            steps_total=int(meta[0]), steps_done=int(meta[1]),
            delta=float(p[0]), rs=float(p[1]), r_max=float(p[2]),
            omega=float(p[3]), order=int(p[4]) if p.shape[0] > 4 else 2,
            layout=layout, opened=dev(opened), esc_pred=dev(esc))


def _load_esc_pred(z, rs):
    """Rescue predicate from a saved carry: the exact predicate under
    'esc'; older JAX carries stored the raw impact parameters under 'b',
    converted with the inward-ray reduction (b > b_crit), exact for every
    camera ray (the pinhole grid never launches outward)."""
    if "esc" in z:
        return np.asarray(z["esc"]).astype(bool)
    if "b" in z:
        b_crit = 3.0 * np.sqrt(3.0) * (0.5 * rs)
        return np.asarray(z["b"]) > b_crit
    return None


def _advance(state16, max_steps, delta, rs, r_max, omega, order=2):
    """Advance a (16, N) carry by at most max_steps masked steps on the
    unfused flows (integrate_batch's loop, the JAX package's XLA chunk):
    (state16, n_steps_applied)."""
    state, applied = plain_cores(tuple(state16), max_steps, delta, rs, r_max,
                                 omega, order)
    return torch.stack(state), applied


def _advance_fused(state16, max_steps, delta, rs, r_max, omega, order=2):
    """Eager twin of kernel B3's chunk (`advance_state_cuda`): at most
    max_steps masked steps on the fused flows."""
    vec = substep_params(delta, rs, r_max, omega, order, state16.dtype,
                         compensated=False, staggered=False)
    state, applied = fused_cores(tuple(state16), max_steps, vec)
    return torch.stack(state), applied


def _advance_eqc(state24, max_steps, delta, rs, r_max, omega, order=2):
    """Eager twin of kernel B4 (`advance_state_eqc_cuda`): at most
    max_steps masked core steps on an opened (24, N) compensated carry —
    integrate_batch_compensated's loop without its open and close."""
    vec = substep_params(delta, rs, r_max, omega, order, state24.dtype)
    state, applied = staggered_cores(tuple(state24), max_steps, vec,
                                     staggered_eqc[1])
    return torch.stack(state), applied


def _finalize_eqc(state24, opened, delta, rs, order=2):
    """Undo the pending opening half-A of the `opened` rays (except those
    parked at r == rs) and fold the deficits: the 12 best-estimate rows,
    the monolithic read-out applied to the carry, which is left as it is.
    The close reads only rs and the first substep's size."""
    vec = substep_params(delta, rs, 0.0, 0.0, order, state24.dtype)
    comps = staggered_close(tuple(state24), opened, vec, staggered_eqc[2])
    return tuple(comps[i] - comps[12 + i] for i in range(12))


def start(q0s, p0s, steps, delta, rs, r_max, omega, order=2,
          compensated=False, device="cuda") -> IntegrationState:
    """Fresh resumable state from (N, 4) launch states (tensors stay on
    their device; arrays go to `device`).

    compensated=True takes the Kahan-compensated staggered equatorial
    layout (requires theta == pi/2, p_theta == 0) and applies its opening
    half-A here, once, to the initially active rays, as the monolithic
    kernel does; steps == 0 opens nothing, so nothing is closed either.
    """
    q0s, p0s = _rays(q0s, p0s, device)
    n = q0s.shape[0]
    esc_pred = schw_true_escape_pred(q0s, p0s, rs)
    n_steps = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    common = dict(n_steps=n_steps, steps_total=int(steps), steps_done=0,
                  delta=float(delta), rs=float(rs), r_max=float(r_max),
                  omega=float(omega), order=int(order), esc_pred=esc_pred)
    if not compensated:
        return IntegrationState(state=torch.stack(pack_state(q0s, p0s)),
                                **common)
    comps = pack_state_eqc(q0s, p0s)
    opened = torch.zeros((n,), dtype=torch.bool, device=q0s.device)
    if int(steps) > 0:
        vec = substep_params(delta, rs, r_max, omega, order, q0s.dtype)
        comps, opened = staggered_open(comps, vec, staggered_eqc[0])
    return IntegrationState(state=torch.stack(comps), layout="eqc",
                            opened=opened, **common)


def advance(st: IntegrationState, chunk_steps: int,
            backend: str = "auto") -> IntegrationState:
    """Advance by at most chunk_steps.

    backend 'auto' takes the kernels for a CUDA carry (B3 for 'generic',
    B4 for 'eqc') and the eager twins for a CPU carry; 'cuda' and 'torch'
    force one side ('cuda' raises for a CPU carry, and for a float64 'eqc'
    carry, which B4 does not take).  Nothing falls back to a twin.
    """
    budget = min(chunk_steps, st.steps_total - st.steps_done)
    if budget <= 0:
        return st
    backend = resolve_backend(backend, st.state.device)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected 'auto', 'cuda' or 'torch')")
    kernel = backend == "cuda"
    if st.layout == "eqc":
        fn = integrate_cuda.advance_state_eqc_cuda if kernel else _advance_eqc
    else:
        fn = integrate_cuda.advance_state_cuda if kernel else _advance
    state, applied = fn(st.state, budget, st.delta, st.rs, st.r_max,
                        st.omega, order=st.order)
    return dataclasses.replace(st, state=state, n_steps=st.n_steps + applied,
                               steps_done=st.steps_done + budget)


def integrate_chunked(q0s, p0s, steps, delta, rs, r_max, omega,
                      chunk_steps=10_000,
                      checkpoint_path: Optional[str] = None,
                      resume: bool = False, order: int = 2,
                      backend: str = "auto",
                      compensated: Optional[bool] = None,
                      device="cuda") -> IntegrationState:
    """Chunked integration with optional on-disk checkpointing.

    With checkpoint_path (an `.npz` file) the carry is saved after every
    chunk, and resume=True continues from that file when it exists.
    compensated=None takes the render's numerics: float32 rays the 'eqc'
    layout (then bit-identical to the monolithic kernel B1 or its twin),
    float64 rays the 'generic' one.
    """
    if checkpoint_path is not None:
        _npz_only(checkpoint_path)
    q0s, p0s = _rays(q0s, p0s, device)
    if compensated is None:
        compensated = q0s.dtype == torch.float32
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        st = IntegrationState.load(checkpoint_path, device=q0s.device)
    else:
        st = start(q0s, p0s, steps, delta, rs, r_max, omega, order=order,
                   compensated=compensated)
    while not st.done:
        st = advance(st, chunk_steps, backend=backend)
        if checkpoint_path:
            st.save(checkpoint_path)
    return st
