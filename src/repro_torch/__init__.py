"""Graft on PyTorch and CUDA: the port of the JAX package ``repro``.

Sub-packages mirror ``repro``'s: ``config``/``configs`` (the model
registry), ``core`` (Graft's planner), ``kernels`` (plain attention and
the Hopper kernels), ``models`` (the dense transformer, fragments and
packed execution) and ``serving`` (the one-shot executor, transport,
telemetry). The port imports nothing of ``repro`` and nothing of JAX.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
