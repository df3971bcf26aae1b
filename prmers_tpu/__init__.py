"""prmers_tpu — Mersenne arithmetic framework on JAX/XLA.

A ground-up JAX re-design of the capabilities of PrMers
(PRP / Lucas-Lehmer / P-1 / ECM on Mersenne numbers M_p = 2^p - 1):
IBDWT NTT over the Goldilocks field with matrix (four-step) transforms,
mesh sharding over a 1-D device axis, and GIMPS ecosystem integration.
"""

__version__ = "0.1.0"
