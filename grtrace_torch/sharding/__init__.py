"""Multi-device rendering and parameter sweeps on torch.distributed: the
('frames', 'rays') mesh (mesh.py) and the line-profile, subring and Fisher
grids laid over it (grid.py)."""

from . import grid, mesh  # noqa: E402,F401
