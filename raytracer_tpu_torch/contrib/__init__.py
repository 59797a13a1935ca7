"""The JAX package's quarantined kernel generations, ported.

Counterparts of `raytracer_tpu/contrib/`: two superseded Jacobi circulant
engines that the JAX package keeps as explicit `AnnulusSolver` methods
and independent cross-checks, never as an `auto` route or a fallback:

  * pallas_circulant -- the lane-gather relaxation sweep, one kernel
    launch per iteration (`csrc/relax.cu`), the ring and slot scans and
    the centre fan in torch ops around it ('pallas');
  * fused_circulant  -- the whole solve in one cooperative kernel launch
    (`csrc/fused.cu`) ('fused').

The port keeps them as the JAX package does: reached only by
`AnnulusSolver(method="pallas")` and `AnnulusSolver(method="fused")`.
"""
