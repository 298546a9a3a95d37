"""Coordinate conversions (spherical <-> Cartesian) and the x-axis rotation
trick — the torch counterpart of `grtrace.physics.coords`.

Conventions:
    theta = arccos(z / r)   (polar angle from +z)
    phi   = atan2(y, x)     (azimuth)
"""
from __future__ import annotations

import torch


def spherical_to_cartesian(r, theta, phi):
    """(r, theta, phi) -> (x, y, z). Batched elementwise."""
    sin_th = torch.sin(theta)
    x = r * sin_th * torch.cos(phi)
    y = r * sin_th * torch.sin(phi)
    z = r * torch.cos(theta)
    return x, y, z


def cartesian_to_spherical(x, y, z):
    """(x, y, z) -> (r, theta, phi). Batched elementwise."""
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(z / r)
    phi = torch.atan2(y, x)
    return r, theta, phi


def rotate_x(x, y, z, angle):
    """Rotate points by `angle` about the +x axis (right-handed).

    R_x(a) = [[1, 0, 0], [0, cos a, -sin a], [0, sin a, cos a]].
    `angle` is a tensor broadcastable against x/y/z.
    """
    c = torch.cos(angle)
    s = torch.sin(angle)
    return x, c * y - s * z, s * y + c * z
