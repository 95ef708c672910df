"""PyTorch/CUDA port of the AReaL-Hex reproduction (``repro`` is the JAX
reference and stays untouched).

The port keeps the reference's layout — layers stacked on a leading
``[L, ...]`` axis, ``x @ W`` weights shaped ``[d_in, d_out]`` and the same
parameter names — so a JAX parameter pytree converts with a plain copy
(``repro_torch.bridge.params_from_jax``).

It imports ``torch``, ``numpy`` and the standard library only: never
``jax`` and never a module of ``repro``.  Every entry point takes
``device=None``, which means ``"cuda"``; on a machine without a GPU the
caller must ask for ``device="cpu"`` explicitly, and then every kernel
wrapper runs its plain PyTorch version.

Ported so far, for the dense family: the static-engine rollout path
(``configs`` -> ``models.transformer`` prefill / decode ->
``rl.rollout.RolloutEngine`` -> ``launch.serve``) and paged
continuous-batching serving (``serve``: paged KV pool, forks, radix
cache, ``PagedEngine``; ``rl.agentic``; ``launch.serve --engine paged``),
with attention through three hand-written Hopper kernels
(``kernels/csrc``).
"""
