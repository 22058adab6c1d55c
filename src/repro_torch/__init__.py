"""SSDUP+ on PyTorch and CUDA.

The same system as the JAX package ``repro``, held against it: traces are
scored per 128-request stream (paper Eq. 1 seek count, Eq. 6 seek
distance) by a hand-written CUDA kernel, and the burst-buffer replay of
every ``scheme x node`` lane of a fleet runs as torch tensor code on the
card (:class:`repro_torch.core.FleetProgram`).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""
