from . import camera, coords, hamiltonian, metric, nullcond
