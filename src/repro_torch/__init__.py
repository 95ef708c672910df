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

Ported: every model family of the reference (``models``, all 13
configs), the static-engine rollout path (``rl.rollout.RolloutEngine``,
``launch.serve``), paged continuous-batching serving (``serve``;
``rl.agentic``), async GRPO training (``launch.train``), checkpoints,
tracing and the AReaL-Hex scheduler (``core``), with attention and the
mLSTM scan through four hand-written Hopper kernels (``kernels/csrc``).
"""
