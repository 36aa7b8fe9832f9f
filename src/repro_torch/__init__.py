"""NOMAD Projection in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``, module for module
(``repro_torch.core.losses`` ↔ ``repro.core.losses``). It imports neither
JAX nor anything of ``repro``; the tests hold it against ``repro``.
Entry points (``core.nomad.NomadProjection``, ``index.build.IndexBuilder``)
run on CUDA unless the caller passes ``device="cpu"``.
"""
