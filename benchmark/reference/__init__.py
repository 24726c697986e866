"""The plain reference that decides ``correct``.

A frozen copy of ``rsoccer_tpu_torch``'s plain VSS-v0 and
SSLStaticDefenders-v0 steps (``core/``, ``physics/``, ``envs/``), of its
Philox counter (``ops/philox.py``) and of the fused step's packed row
layout (``layout.py``), in plain PyTorch.  Nothing here imports ``jax``,
the JAX package or the port: a later change to the port leaves this copy as it is, so the port is held to
what it computed when the benchmark was written.
"""
