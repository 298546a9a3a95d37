"""Drop-in API compatibility layers (the torch counterpart of
`grtrace.compat`)."""
from .einsteinpy import Geodesic, Nulllike, Timelike  # noqa: F401
