"""Static analysis of the port's CUDA kernel layer (the counterpart of
``repro.analysis``).

Two layers, both run without a card:

- :mod:`repro_torch.analysis.contracts` — the contract checker: for every
  entry point registered in :mod:`repro_torch.kernels.registry`,
  enumerate each canonical instance's launches block by block and prove
  bounds, live extents and their pads, spares, output aliasing, 16-byte
  alignment and the launch limits;
- :mod:`repro_torch.analysis.lint` — AST rules over ``src/repro_torch``
  enforcing the port's invariants the checker cannot see from one launch
  (flat arrays sized through the pad helpers, no fallback to the CPU, a
  launch counter in every wrapper, no build at import time).

CLI: ``python -m repro_torch.analysis {check,lint,selftest}``.
"""

from repro_torch.analysis.contracts import Finding, check_all, check_contract

__all__ = ["Finding", "check_all", "check_contract"]
