"""Compute backends.

The protocol layer (kzg_rust_tpu_torch.protocol) is written against a small
duck-typed backend surface covering the heavy math:

* ``barycentric_eval(settings, evals, x)``  -> int
* ``quotient_out_of_domain(settings, evals, z, y)`` -> list[int]
* ``quotient_in_domain(settings, evals, z, y, m)``  -> list[int]
* ``msm_g1_lagrange(settings, scalars)``   -> G1 point (MSM over the setup)
* ``g1_lincomb(points, scalars)``          -> G1 point (runtime bases)
* ``g1_mul / g1_sub / g2_mul / g2_sub``    -> group ops
* ``pairings_verify(a1, a2, b1, b2)``      -> bool

Backends: ``golden`` (pure-Python oracle) and ``torch`` (CUDA tensor path;
``TorchBackend(device="cpu")`` runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

_CACHE: dict = {}


def get_backend(name: str):
    if name in _CACHE:
        return _CACHE[name]
    if name == "golden":
        from .golden_backend import GoldenBackend

        backend = GoldenBackend()
    elif name == "torch":
        from .torch_backend import TorchBackend

        backend = TorchBackend()
    else:
        raise ValueError(f"unknown backend {name!r}")
    _CACHE[name] = backend
    return backend
