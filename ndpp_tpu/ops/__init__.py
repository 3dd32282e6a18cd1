"""Device-side numerical kernels (JAX/XLA).

This package is the device-side equivalent of the reference's Fortran
numerical core (``scatt.F90``/``freegas.F90``/``chi.F90`` per SURVEY.md
section 2): everything here is pure-functional, statically shaped, and
vectorized over (incident-energy tile x outgoing group x Legendre order).
"""
